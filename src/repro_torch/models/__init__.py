"""The LM stack of the port: configuration schema, layers, parameters,
MoE, Griffin and xLSTM blocks and the model assembly, in plain PyTorch
(the reference computes every LM op with jnp einsums and elementwise
ops; no Pallas kernel lies on this path)."""
