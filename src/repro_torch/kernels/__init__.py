# Hand-written Hopper kernels of the port, one per TPU kernel of the
# reference: <name>.py (the wrapper) + csrc/<name>.cu (the CUDA source),
# with ops.py (device dispatch + launch counts) and ref.py (the plain
# PyTorch versions) beside them.  Kernels are built by build.py at first
# use, never at import.
