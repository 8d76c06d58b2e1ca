"""The benchmark of dg_sct_tpu_torch: `python -m portbench --workload <name>
--seed <n> --seconds <s> --trace <0|1>` (see `bench.py`)."""
