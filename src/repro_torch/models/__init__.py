"""The language-model substrate's serving path (port of ``repro.models``):
configs, layers, attention, MoE, Mamba2/SSD, the transformer assembly,
weight conversion from the JAX package's trees, and the step factories."""
