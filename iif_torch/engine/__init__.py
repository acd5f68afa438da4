"""Training engine: LR schedules, the optimizer and the detection
trainer."""
