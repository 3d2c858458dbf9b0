"""Training: the Trainer, schedules, checkpoints, the loop and task losses."""
