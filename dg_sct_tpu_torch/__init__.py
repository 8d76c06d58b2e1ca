"""PyTorch/CUDA port of dg_sct_tpu: DG-SCT AVE serving and training on an
NVIDIA H100, with the three TPU kernels rewritten as CUDA kernels for sm_90a.

The forward (`models.ave`, eval and train mode), the inference engine over
arrays in memory or a dataset on disk (`serve`, `data.ave`, the native JPEG
core in `native`), the trainer (`train.ave_train`, `train.ave_main`), and
the import of DG-SCT checkpoints (`utils.torch_convert`,
`tools.import_eval`). Parameters are nested dicts and lists of tensors in
the JAX package's layout (linear kernels (in, out)), so `weights.from_jax`
carries a JAX or converted tree across leaf for leaf. Entry points run on
the card unless the caller passes `device="cpu"`.
"""
