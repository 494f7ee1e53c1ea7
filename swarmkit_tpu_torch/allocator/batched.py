"""Batched allocator subsystem: array-native IPAM pools and port
bookkeeping, bit-identical to the scalar oracles (the port's copy of the
JAX package's `allocator/batched.py`).

`BatchedIPAM` / `BatchedPorts` are drop-in replacements for `IPAM` /
`PortAllocator` (the scalar classes stay as the CPU oracles — the seeded
fuzz in tests/test_torch_alloc.py pins grants, release order, cursor
state and exhaustion behavior across every public op). The allocator's
hot half — moving whole PENDING batches — grants addresses through
`allocate_many`: one `ops/alloc.py` grant-order call per (network,
chunk) instead of one probe loop per task, legal because a batch of K
grants with no interleaved release IS K sequential scalar grants
(ops/alloc.py module docs). A pool of more than POOL_THRESHOLD = 4,096
addresses (a /19 or larger) takes that call on the card, kernel K19.

Parity rules this module must preserve:
- grant order: the circular probe order starting at the pool cursor,
  cursor left just past the last grant;
- partial failure: a dynamic-port run that exhausts mid-way applies
  exactly the grants the scalar loop would have applied before failing;
- release never moves the cursor, the gateway is never released.
"""
from __future__ import annotations

import functools
import ipaddress

import numpy as np

from ..ops import alloc as _alloc
from .allocator import (
    DYNAMIC_PORT_END,
    DYNAMIC_PORT_START,
    PortAllocator,
)
from .ipam import IPAM, IPAMError

_PORT_SPAN = DYNAMIC_PORT_END - DYNAMIC_PORT_START + 1


class _ArrayPool:
    """Array twin of ipam._Pool: occupancy as a flat bool mask, grants
    via the shared circular-order primitive, on `device` above
    POOL_THRESHOLD slots (None: the current CUDA device; "cpu": the plain
    version). The fuzz pins the values against the scalar oracle."""

    def __init__(self, subnet: ipaddress.IPv4Network, device=None):
        self.subnet = subnet
        self.device = device
        self.gateway = str(subnet.network_address + 1)
        size = subnet.num_addresses
        self.taken = np.zeros(size, bool)
        self.taken[1] = True            # the gateway
        self._cursor = 2

    # -- oracle-parity surface (ipam._Pool) ------------------------------
    def allocate(self) -> str:
        """Single grant: the scalar pool's incremental probe, verbatim,
        over the mask — O(probe distance), not a whole-pool order
        computation (single grants are the service-VIP / node-ingress /
        fallback shape; the kernel earns its keep on k > 1)."""
        size = self.taken.shape[0]
        taken = self.taken
        offset = self._cursor
        for _ in range(size):
            if offset >= size - 1:      # skip broadcast (scalar wrap)
                offset = 2
            if not taken[offset]:
                taken[offset] = True
                self._cursor = offset + 1
                return str(self.subnet.network_address + offset)
            offset += 1
        raise IPAMError(f"subnet {self.subnet} exhausted")

    def allocate_many(self, k: int) -> list[str]:
        """K grants in probe order — all-or-nothing (callers that need
        the scalar loop's grant-then-raise shape fall back to k
        `allocate()` calls, which are bit-identical per grant)."""
        if k <= 0:
            return []
        size = self.taken.shape[0]
        order = _alloc.grant_order(self.taken, self._cursor, 2, size - 2,
                                   device=self.device)
        if k > order.shape[0]:
            raise IPAMError(f"subnet {self.subnet} exhausted")
        offs = order[:k]
        self.taken[offs] = True
        self._cursor = int(offs[-1]) + 1
        base = self.subnet.network_address
        return [str(base + int(o)) for o in offs]

    def free_count(self) -> int:
        size = self.taken.shape[0]
        return int((~self.taken[2:size - 1]).sum())

    def reserve(self, addr: str) -> None:
        ip = ipaddress.ip_address(addr)
        if ip not in self.subnet:
            raise IPAMError(f"{addr} outside {self.subnet}")
        self.taken[int(ip) - int(self.subnet.network_address)] = True

    def release(self, addr: str) -> None:
        if addr == self.gateway:
            return
        try:
            off = int(ipaddress.ip_address(addr)) \
                - int(self.subnet.network_address)
        except ValueError:
            return                      # scalar discard() tolerance
        if 0 <= off < self.taken.shape[0] and off != 1:
            self.taken[off] = False

    @property
    def allocated(self) -> set[str]:
        """Parity view of the scalar pool's `allocated` set (consumers
        and the fuzz read it; the mask is the storage)."""
        base = self.subnet.network_address
        return {str(base + int(o)) for o in np.flatnonzero(self.taken)}


class BatchedIPAM(IPAM):
    """IPAM over array pools, plus the whole-batch grant surface. Every
    pool grants on `device` (see `_ArrayPool`)."""

    _POOL_CLS = _ArrayPool

    def __init__(self, device=None):
        super().__init__()
        self._POOL_CLS = functools.partial(_ArrayPool, device=device)

    def allocate_many(self, net_id: str, k: int) -> list[str]:
        with self._lock:
            pool = self._pools.get(net_id)
            if pool is None:
                raise IPAMError(f"unknown network {net_id}")
            return pool.allocate_many(k)

    def free_count(self, net_id: str) -> int:
        with self._lock:
            pool = self._pools.get(net_id)
            return 0 if pool is None else pool.free_count()


class BatchedPorts(PortAllocator):
    """PortAllocator with the dynamic range mirrored as per-protocol
    masks: consecutive same-protocol dynamic picks inside one service's
    allocation run as ONE kernel grant, explicit claims scatter into
    the mask between runs — the run segmentation is what keeps a batch
    bit-identical to the scalar loop (including its partial-grant
    failure shape). The default dynamic range spans 2,768 ports, at or
    below POOL_THRESHOLD, so its grants run in numpy, as in the JAX
    package."""

    def __init__(self):
        super().__init__()
        self._masks: dict[str, np.ndarray] = {}

    def _mask(self, protocol: str) -> np.ndarray:
        m = self._masks.get(protocol)
        if m is None:
            m = self._masks[protocol] = np.zeros(_PORT_SPAN, bool)
        return m

    def _claim(self, protocol: str, port: int, service_id: str) -> None:
        self._allocated[(protocol, port)] = service_id
        if DYNAMIC_PORT_START <= port <= DYNAMIC_PORT_END:
            self._mask(protocol)[port - DYNAMIC_PORT_START] = True

    def _unclaim(self, key: tuple[str, int]) -> None:
        protocol, port = key
        if DYNAMIC_PORT_START <= port <= DYNAMIC_PORT_END:
            self._mask(protocol)[port - DYNAMIC_PORT_START] = False

    def _grant_dynamic_run(self, protocol: str, k: int) -> list[int]:
        """Up to k dynamic ports in probe order (may return fewer when
        the range exhausts — the caller applies the partial exactly as
        the scalar loop would before failing). Cursor lands just past
        the last grant."""
        order = _alloc.grant_order(
            self._mask(protocol),
            self._next_dynamic - DYNAMIC_PORT_START, 0, _PORT_SPAN - 1)
        grants = [DYNAMIC_PORT_START + int(o) for o in order[:k]]
        if grants:
            self._next_dynamic = grants[-1] + 1
            if self._next_dynamic > DYNAMIC_PORT_END:
                self._next_dynamic = DYNAMIC_PORT_START
        return grants

    def _find_dynamic(self, protocol: str):
        grants = self._grant_dynamic_run(protocol, 1)
        return grants[0] if grants else None

    def allocate(self, service_id: str, ports) -> bool:
        with self._lock:
            for p in ports:
                if p.published_port:
                    owner = self._allocated.get(
                        (p.protocol, p.published_port))
                    if owner is not None and owner != service_id:
                        return False
            i, n = 0, len(ports)
            while i < n:
                p = ports[i]
                if p.published_port:
                    self._claim(p.protocol, p.published_port, service_id)
                    i += 1
                    continue
                if p.publish_mode != "ingress":
                    i += 1
                    continue
                # maximal run of consecutive same-protocol dynamic picks
                j = i
                while (j < n and not ports[j].published_port
                       and ports[j].publish_mode == "ingress"
                       and ports[j].protocol == p.protocol):
                    j += 1
                grants = self._grant_dynamic_run(p.protocol, j - i)
                for q, port in zip(ports[i:i + len(grants)], grants):
                    q.published_port = port
                    self._claim(q.protocol, port, service_id)
                if len(grants) < j - i:
                    return False        # scalar shape: partial applied
                i = j
            return True

    def release(self, service_id: str):
        with self._lock:
            for key in [k for k, v in self._allocated.items()
                        if v == service_id]:
                del self._allocated[key]
                self._unclaim(key)

    def release_except(self, service_id: str,
                       keep: set[tuple[str, int]]) -> bool:
        with self._lock:
            stale = [k for k, v in self._allocated.items()
                     if v == service_id and k not in keep]
            for k in stale:
                del self._allocated[k]
                self._unclaim(k)
            return bool(stale)
