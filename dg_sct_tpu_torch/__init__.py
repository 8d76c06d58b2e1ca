"""PyTorch/CUDA port of dg_sct_tpu: the DG-SCT AVE eval forward on an NVIDIA
H100, with the three TPU kernels rewritten as CUDA kernels for sm_90a.

Parameters are nested dicts and lists of tensors in the JAX package's
layout (linear kernels (in, out)), so `weights.from_jax` carries a JAX tree
across leaf for leaf. Entry points run on the card unless the caller passes
`device="cpu"`.
"""
