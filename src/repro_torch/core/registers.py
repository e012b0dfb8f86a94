"""Memory-mapped register file + the fb_read_32/fb_write_32 protocol
(paper §IV-A).

The register file is the control plane of every "accelerator" in this repo:
the serving engine, the co-verification examples, and the protocol fuzz
tests all drive hardware-style CSRs through these two calls.  Accesses are
transaction-logged; protocol violations (unmapped address, RO write,
doorbell-while-busy) are recorded rather than raised, so randomized
protocol tests can assert on them — the software analogue of the paper's
"register-level protocol testing".
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

from repro_torch.core.transactions import Transaction, TransactionLog

RO = "ro"
RW = "rw"
W1C = "w1c"          # write-1-to-clear (interrupt/status style)
DOORBELL = "doorbell"  # write triggers an action callback


@dataclasses.dataclass
class Register:
    name: str
    addr: int
    access: str = RW
    reset: int = 0
    on_write: Optional[Callable[[int], None]] = None   # doorbell action
    # invoked before each fb_read_32 returns, so hardware can refresh
    # status bits the moment firmware looks at them (poll-driven devices)
    on_read: Optional[Callable[[], None]] = None


class RegisterFile:
    """32-bit register space with FireBridge access semantics."""

    def __init__(self, name: str = "csr",
                 log: Optional[TransactionLog] = None) -> None:
        self.name = name
        self.log = log if log is not None else TransactionLog()
        self._by_addr: Dict[int, Register] = {}
        self._val: Dict[int, int] = {}
        self.time = 0.0

    def define(self, name: str, addr: int, access: str = RW, reset: int = 0,
               on_write: Optional[Callable[[int], None]] = None,
               on_read: Optional[Callable[[], None]] = None) -> Register:
        if addr in self._by_addr:
            raise ValueError(f"register address collision at {addr:#x}")
        if addr % 4:
            raise ValueError(f"register {name} not 4-byte aligned: {addr:#x}")
        reg = Register(name, addr, access, reset, on_write, on_read)
        self._by_addr[addr] = reg
        self._val[addr] = reset & 0xFFFFFFFF
        return reg

    def addr_of(self, name: str) -> int:
        for r in self._by_addr.values():
            if r.name == name:
                return r.addr
        raise KeyError(name)

    # ------------------------------------------------------------ protocol
    def fb_read_32(self, addr: int) -> int:
        self.time += 1
        self.log.log(Transaction(self.time, self.name, "read", addr, 4))
        reg = self._by_addr.get(addr)
        if reg is None:
            self.log.violation(f"read from unmapped address {addr:#x}")
            return 0xDEADBEEF
        if reg.on_read is not None:
            reg.on_read()
        return self._val[addr]

    def fb_write_32(self, addr: int, data: int) -> None:
        self.time += 1
        self.log.log(Transaction(self.time, self.name, "write", addr, 4))
        reg = self._by_addr.get(addr)
        data &= 0xFFFFFFFF
        if reg is None:
            self.log.violation(f"write to unmapped address {addr:#x}")
            return
        if reg.access == RO:
            self.log.violation(
                f"write to read-only register {reg.name} @ {addr:#x}")
            return
        if reg.access == W1C:
            self._val[addr] &= ~data & 0xFFFFFFFF
        else:
            self._val[addr] = data
        if reg.on_write is not None:
            reg.on_write(data)

    # --------------------------------------------- checkpoint/restore hooks
    def get_state(self) -> Dict:
        """Register values + protocol clock for a replay checkpoint
        (core/replay.py).  The register *map* (define() calls, hooks) is
        structure, not state — a restored file must already have it."""
        return {"vals": dict(self._val), "time": self.time}

    def set_state(self, state: Dict) -> None:
        self._val.clear()
        self._val.update(state["vals"])
        self.time = state["time"]

    # ------------------------------------------------- hardware-side access
    def hw_set(self, name: str, value: int) -> None:
        """Hardware-side status update (not a bus transaction)."""
        self._val[self.addr_of(name)] = value & 0xFFFFFFFF

    def hw_get(self, name: str) -> int:
        return self._val[self.addr_of(name)]

    def poll(self, name: str, mask: int, value: int,
             max_reads: int = 10_000, strict: bool = False) -> int:
        """Poll a status register until (reg & mask) == value.

        Returns the number of reads on success.  On timeout a violation is
        recorded and -1 is returned — distinguishable from a success on the
        final read, which returns ``max_reads`` — or, with ``strict=True``,
        ``TimeoutError`` is raised instead.
        """
        addr = self.addr_of(name)
        for n in range(1, max_reads + 1):
            if (self.fb_read_32(addr) & mask) == value:
                return n
        self.log.violation(f"poll timeout on {name} mask={mask:#x}")
        if strict:
            raise TimeoutError(
                f"poll timeout on {name} mask={mask:#x} value={value:#x} "
                f"after {max_reads} reads")
        return -1
