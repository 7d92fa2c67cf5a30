"""The benchmark of online_gp_torch: ``python3 -m gpbench --workload <cell>
--seed <n> --seconds <s> --trace <0|1>`` (see README.md)."""
