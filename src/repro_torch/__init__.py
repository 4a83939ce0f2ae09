# The PyTorch/CUDA port of the BET stack (``repro``, the JAX reference,
# lives beside it and is never imported from here).  Module names mirror
# the reference's so each counterpart is easy to find; entry points take
# ``device=`` and run on the card unless the caller asks for the CPU
# (``repro_torch.device.resolve_device``).
