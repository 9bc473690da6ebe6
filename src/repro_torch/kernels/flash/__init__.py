"""Flash attention forward: the hand-written Hopper kernel, its plain
version, the one-shot oracle and the registry descriptor."""
