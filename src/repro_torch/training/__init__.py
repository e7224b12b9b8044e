"""Training: AdamW, the train step, checkpointing, fault-tolerance hooks."""
