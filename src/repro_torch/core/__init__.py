"""FireBridge core: the paper's contribution as a composable subsystem.

  registers     — fb_read_32/fb_write_32 CSR protocol (paper §IV-A)
  transactions  — burst log + bandwidth/heatmap profiling (Figs. 8, 9)
  bridge        — DDR memory bridge + multi-backend accelerator launch (§IV)
  congestion    — seeded interconnect contention / DoS emulator, online
                  LinkModel + offline replay (§IV-C)
  counters      — always-on sampled counter banks + counter-diff digests
  equivalence   — oracle ≡ interpret ≡ compiled checking w/ localization
  coverify      — one-call co-verification entry point (debug-iteration unit)
"""
from repro_torch.core.bridge import Buffer, FireBridge, MemoryBridge
from repro_torch.core.congestion import (CongestionConfig, CongestionResult,
                                         LinkModel, simulate)
from repro_torch.core.coverify import CoverifyResult, coverify
from repro_torch.core.equivalence import (EquivalenceReport,
                                          check_equivalence, compare_outputs)
from repro_torch.core.registers import DOORBELL, RO, RW, W1C, RegisterFile
from repro_torch.core.transactions import Transaction, TransactionLog

__all__ = [
    "Buffer", "FireBridge", "MemoryBridge", "CongestionConfig",
    "CongestionResult", "LinkModel", "simulate", "CoverifyResult",
    "coverify", "EquivalenceReport", "check_equivalence", "compare_outputs",
    "RegisterFile", "RO", "RW", "W1C", "DOORBELL", "Transaction",
    "TransactionLog",
]
