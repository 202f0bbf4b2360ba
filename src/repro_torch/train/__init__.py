"""Training of the port: losses, AdamW, the train step and checkpoints."""
