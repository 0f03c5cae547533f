"""Run-time observability: structured metric logging."""
