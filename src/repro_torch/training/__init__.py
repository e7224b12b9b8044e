"""Training: AdamW, the train step, checkpointing, fault tolerance and
elastic planning, the int8 error-feedback all-reduce, GPipe."""
