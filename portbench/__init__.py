"""portbench: the benchmark of ``xsdba_tpu_torch`` on an NVIDIA GPU.

``python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
from the root of a checkout; see ``run.py``.
"""
