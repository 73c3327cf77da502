"""Configurations of the port.

The paper's own workload: Baidu DeepBench RNN inference tasks (Table 6),
copied from ``repro.configs``.  ``get_config(arch_id)`` resolves the LM
architectures the port serves so far (rwkv6-1.6b, qwen2.5-14b).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs import qwen2_5_14b, rwkv6_1_6b
from repro_torch.configs.base import ModelConfig

ARCHS: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG for m in (rwkv6_1_6b, qwen2_5_14b)}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; the port serves "
                       f"{sorted(ARCHS)} so far")
    return ARCHS[arch]


@dataclasses.dataclass(frozen=True)
class DeepBenchTask:
    cell: str            # "lstm" | "gru"
    hidden: int          # H (== input features D in DeepBench)
    timesteps: int       # T
    # Paper-reported latencies in ms (Table 6) for comparison columns.
    ms_cpu: float = 0.0
    ms_v100: float = 0.0
    ms_brainwave: float = 0.0
    ms_plasticine: float = 0.0

    @property
    def name(self) -> str:
        return f"{self.cell}-h{self.hidden}-t{self.timesteps}"


DEEPBENCH_TASKS = (
    DeepBenchTask("lstm", 256, 150, 15.75, 1.69, 0.425, 0.0419),
    DeepBenchTask("lstm", 512, 25, 11.50, 0.60, 0.077, 0.0139),
    DeepBenchTask("lstm", 1024, 25, 107.65, 0.71, 0.074, 0.0292),
    DeepBenchTask("lstm", 1536, 50, 411.00, 4.38, 0.145, 0.1224),
    DeepBenchTask("lstm", 2048, 25, 429.36, 1.55, 0.074, 0.1060),
    DeepBenchTask("gru", 512, 1, 0.91, 0.39, 0.013, 0.0004),
    DeepBenchTask("gru", 1024, 1500, 3810.00, 33.77, 3.792, 1.4430),
    DeepBenchTask("gru", 1536, 375, 2730.00, 13.12, 0.951, 0.7463),
    DeepBenchTask("gru", 2048, 375, 5040.00, 17.70, 0.954, 1.2833),
    DeepBenchTask("gru", 2560, 375, 7590.00, 23.57, 0.993, 1.9733),
)
