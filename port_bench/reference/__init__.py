"""Plain PyTorch references of the benchmark's configurations, in float32
with TF32 off. They import neither JAX nor anything of the port, and take
only what the benchmark makes: the weights, the features and the traffic.
"""
