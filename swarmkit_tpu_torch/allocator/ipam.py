"""IPAM: subnet pools and address allocation for cluster networks.

Behavioral re-derivation of the reference's IPAM usage inside
manager/allocator/network.go:448-1132 (via libnetwork's default address
pools): every network gets a subnet (from its spec, or auto-assigned from
the default 10.0.0.0/8 space carved into /24s), a gateway (first host
address), and sequential host addresses for service VIPs, task attachment
addresses, and node attachments. State is rebuilt idempotently from the
replicated store on leadership change (`reserve` — the restore path of
doNetworkInit), so the allocator never double-assigns across failovers.

The port's copy of the JAX package's `allocator/ipam.py`.
"""
from __future__ import annotations

import ipaddress

from ..analysis.lockgraph import make_lock


class IPAMError(Exception):
    pass


def validate_subnet(subnet: str) -> ipaddress.IPv4Network:
    """Parse and validate an operator-specified subnet. The single source
    of truth for the minimum size — the control API calls this at network
    create time so allocation can't later fail on a subnet the API
    accepted."""
    try:
        net = ipaddress.ip_network(subnet, strict=False)
    except ValueError as exc:
        raise IPAMError(f"invalid subnet {subnet!r}: {exc}")
    # gateway is network+1 and hosts start at network+2, so anything
    # smaller than /30 has no allocatable host address
    if net.num_addresses < 4:
        raise IPAMError(
            f"subnet {net} too small: need at least a /30 "
            "(gateway + one host address)")
    return net


class _Pool:
    """The scalar pool: the oracle that `batched._ArrayPool` equals grant
    for grant (tests/test_torch_alloc.py)."""

    def __init__(self, subnet: ipaddress.IPv4Network):
        self.subnet = subnet
        self.gateway = str(subnet.network_address + 1)
        self.allocated: set[str] = {self.gateway}
        self._cursor = 2  # host addresses start past the gateway

    def allocate(self) -> str:
        size = self.subnet.num_addresses
        offset = self._cursor
        # bounded probe: at most one full sweep of the host range — a
        # wrap-relative termination check can spin forever when the cursor
        # sits at the wrap target on an exhausted pool
        for _ in range(size):
            if offset >= size - 1:      # skip broadcast
                offset = 2
            addr = str(self.subnet.network_address + offset)
            if addr not in self.allocated:
                self.allocated.add(addr)
                self._cursor = offset + 1
                return addr
            offset += 1
        raise IPAMError(f"subnet {self.subnet} exhausted")

    def reserve(self, addr: str) -> None:
        if ipaddress.ip_address(addr) not in self.subnet:
            raise IPAMError(f"{addr} outside {self.subnet}")
        self.allocated.add(addr)

    def release(self, addr: str) -> None:
        if addr != self.gateway:
            self.allocated.discard(addr)


class IPAM:
    """Per-network address pools with auto subnet assignment."""

    DEFAULT_SPACE = ipaddress.ip_network("10.0.0.0/8")
    DEFAULT_PREFIX = 24
    # pool implementation seam: allocator/batched.py BatchedIPAM swaps
    # in the array-native pool (bit-identical semantics, fuzz-pinned)
    _POOL_CLS = _Pool

    def __init__(self):
        self._pools: dict[str, _Pool] = {}
        self._lock = make_lock('allocator.ipam.lock')

    # ------------------------------------------------------------ networks
    def add_network(self, net_id: str,
                    subnet: str | None = None) -> tuple[str, str]:
        """Create (or re-create, on restore) a network's pool. Returns
        (subnet_cidr, gateway)."""
        with self._lock:
            pool = self._pools.get(net_id)
            if pool is not None:
                return str(pool.subnet), pool.gateway
            if subnet:
                net = validate_subnet(subnet)
            else:
                net = self._next_free_subnet()
            pool = self._POOL_CLS(net)
            self._pools[net_id] = pool
            return str(net), pool.gateway

    def _next_free_subnet(self) -> ipaddress.IPv4Network:
        used = {p.subnet for p in self._pools.values()}
        for candidate in self.DEFAULT_SPACE.subnets(
                new_prefix=self.DEFAULT_PREFIX):
            if not any(candidate.overlaps(u) for u in used):
                return candidate
        raise IPAMError("default address space exhausted")

    def remove_network(self, net_id: str) -> None:
        with self._lock:
            self._pools.pop(net_id, None)

    def has_network(self, net_id: str) -> bool:
        with self._lock:
            return net_id in self._pools

    # ----------------------------------------------------------- addresses
    def allocate(self, net_id: str) -> str:
        with self._lock:
            pool = self._pools.get(net_id)
            if pool is None:
                raise IPAMError(f"unknown network {net_id}")
            return pool.allocate()

    def reserve(self, net_id: str, addr: str) -> None:
        """Restore path: mark an address from replicated state as taken."""
        with self._lock:
            pool = self._pools.get(net_id)
            if pool is not None:
                pool.reserve(addr)

    def release(self, net_id: str, addr: str) -> None:
        with self._lock:
            pool = self._pools.get(net_id)
            if pool is not None:
                pool.release(addr)
