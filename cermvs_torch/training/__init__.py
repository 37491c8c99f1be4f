"""Training: sequence loss, AdamW under a linear OneCycle schedule, the
single-device train step, checkpoints and the configurable ``train`` loop."""
