"""Model configurations: a copy of `repro.configs` for the port."""
