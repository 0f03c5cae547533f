"""Two-stage prompt-learning training: losses, schedules, the optimizer and the trainer."""
