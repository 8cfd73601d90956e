"""PyTorch + CUDA port of soccernerfs_tpu for NVIDIA Hopper (H100).

The JAX package ``soccernerfs_tpu`` is the reference; this package mirrors
its layout (core/ ops/ fields/ models/ engine/ configs/) and names so each
function has an obvious counterpart.  Plain tensor code is PyTorch; every
kernel the JAX package wrote in Pallas for the TPU is a CUDA kernel written
by hand for sm_90a (``csrc/``, bound in ``ops/kernels/``).

Entry points run on ``torch.device("cuda")`` unless the caller passes
another device; they raise when CUDA is asked for and absent.  The package
never imports JAX or the JAX package.
"""
