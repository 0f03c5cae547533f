"""OpenAI-format state dict -> port parameter dicts."""
