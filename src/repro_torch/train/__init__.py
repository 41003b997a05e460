"""Training of the port (``repro.train``): the SASP-aware train step,
AdamW, schedules and checkpoints."""
