# The reference's examples/ on the port: each module runs with
# ``python -m repro_torch.examples.<name> [--device cpu]``.
