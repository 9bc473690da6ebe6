"""The dense decoder model: layers, attention, transformer blocks, the
`Model` assembly and JAX-weight conversion."""
