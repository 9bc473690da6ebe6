"""Optimizers (AdamW, Adafactor) and learning-rate schedules, from
scratch on dicts of tensors as the JAX package builds them on pytrees."""
