"""The training data pipeline: step-keyed synthetic or token-file
batches and background prefetch."""
