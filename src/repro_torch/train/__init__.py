"""The training path: the train step and the fault-tolerant loop."""
