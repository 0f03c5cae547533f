"""Host tools of the port: synthetic datasets, the parity harness, caption prompts, the parity runbook."""
