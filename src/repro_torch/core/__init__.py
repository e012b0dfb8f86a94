"""FireBridge core: the paper's contribution as a composable subsystem.

  registers     — fb_read_32/fb_write_32 CSR protocol (paper §IV-A)
  transactions  — burst log + bandwidth/heatmap profiling (Figs. 8, 9)
  bridge        — DDR memory bridge + multi-backend accelerator launch (§IV)
  congestion    — seeded interconnect contention / DoS emulator, online
                  LinkModel + offline replay (§IV-C)
  counters      — always-on sampled counter banks + counter-diff digests
  equivalence   — oracle ≡ interpret ≡ compiled checking w/ localization
  coverify      — one-call co-verification entry point (debug-iteration unit)
  fabric        — multi-device cluster with modeled interconnect: per-port
                  links + shared host channel, sharded launches, ring
                  all_reduce (FireSim-style scale-out)
  topology      — switched-interconnect shapes (ring / 2D-torus / fat
                  tree) with static routing tables
  switch        — modeled flit switch layer: per-port arbitration +
                  credit-based flow control over the topology graph
  coverage      — functional-coverage bins over protocol/burst/congestion/
                  fault/fabric stimulus, fed by fuzz + fabric
  fuzz          — seeded fault injection + randomized protocol stimulus
                  with differential checking and trace shrinking
  scheduler     — batched multi-backend sweep (CoVerifySession, Fig. 5)
  replay        — time-travel replay + divergence bisection
  profiler      — off-chip data-movement profiling: exhaustive stall
                  attribution, Perfetto export (§IV)
  hlo_profiler  — a program's FLOPs, traffic and collective bytes (the
                  reference's HLO parser, and a dispatcher op counter for
                  the port's programs) + roofline terms at one H100's peaks
"""
from repro_torch.core.bridge import Buffer, FireBridge, MemoryBridge
from repro_torch.core.congestion import (CongestionConfig, CongestionResult,
                                         LinkModel, simulate)
from repro_torch.core.coverage import CoverageModel
from repro_torch.core.coverify import CoverifyResult, coverify
from repro_torch.core.equivalence import (EquivalenceReport,
                                          check_equivalence, compare_outputs)
from repro_torch.core.fabric import FABRIC_LINK, FabricCluster, sharded_launch
from repro_torch.core.fuzz import (FaultEvent, FaultPlan, FuzzReport,
                                   ProtocolFuzzer, run_fuzz)
from repro_torch.core.profiler import (CATEGORIES, DataMovementProfiler,
                                       RooflinePlacement, StallBreakdown,
                                       profile_recording, profile_window,
                                       validate_trace)
from repro_torch.core.registers import DOORBELL, RO, RW, W1C, RegisterFile
from repro_torch.core.replay import (DebugSession, DivergenceReport,
                                     Recording, RecordingBridge,
                                     ReplayWindow, bisect_divergence,
                                     record_serving_storm)
from repro_torch.core.scheduler import (CellResult, CoVerifySession,
                                        SweepCell, SweepReport,
                                        run_sequential)
from repro_torch.core.switch import SwitchFabric, SwitchPort
from repro_torch.core.topology import (TOPOLOGY_KINDS, Topology,
                                       build_topology, fat_tree, ring,
                                       torus2d)
from repro_torch.core.transactions import Transaction, TransactionLog

__all__ = [
    "Buffer", "FireBridge", "MemoryBridge", "CongestionConfig",
    "CongestionResult", "LinkModel", "simulate", "CoverageModel",
    "CoverifyResult", "coverify", "EquivalenceReport", "check_equivalence",
    "compare_outputs", "FABRIC_LINK", "FabricCluster", "sharded_launch",
    "FaultEvent", "FaultPlan", "FuzzReport", "ProtocolFuzzer", "run_fuzz",
    "RegisterFile", "RO", "RW", "W1C", "DOORBELL", "CellResult",
    "CoVerifySession", "SweepCell", "SweepReport", "run_sequential",
    "Transaction", "TransactionLog", "DebugSession", "DivergenceReport",
    "Recording", "RecordingBridge", "ReplayWindow", "bisect_divergence",
    "record_serving_storm", "CATEGORIES", "DataMovementProfiler",
    "RooflinePlacement", "StallBreakdown", "profile_recording",
    "profile_window", "validate_trace", "Topology", "build_topology",
    "ring", "torus2d", "fat_tree", "TOPOLOGY_KINDS", "SwitchFabric",
    "SwitchPort",
]
