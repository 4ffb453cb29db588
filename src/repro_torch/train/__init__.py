"""Training: optimizers, metrics, checkpoints and the Trainer loop (torch
port of ``repro/train``)."""
