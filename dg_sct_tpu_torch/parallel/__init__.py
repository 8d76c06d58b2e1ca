"""Parallel modes of the port over `torch.distributed` process groups
(`dg_sct_tpu/parallel/`):

- `mesh`: the world (`init_world`, torchrun's environment), meshes of
  process groups over the axes `data`, `model`, `seq` and `pipe`, batch
  sharding, replication and the tensor-parallel sharding of a tree;
- `comm`: the collectives the model's code runs (the data-parallel batch
  norm and mixup, gradient averaging, the frames of a sequence-parallel
  eval);
- `tp`: the tensor-parallel (Megatron) half-blocks and MLPs of an eval
  forward;
- `pipeline`: GPipe over a list of uniform stages (stage 2's pairs in eval).

Data parallelism trains (`train.ave_main` under torchrun, or with
`--world-size/--rank/--init-method`); tensor, sequence and pipeline
parallelism run eval forwards (`models.ave.forward`'s `tp`, `seq` and
`pipeline`). Importing this package starts no process group.
"""
