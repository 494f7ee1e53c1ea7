"""The binpack kernel (K9) against its plain PyTorch version on the card,
and binpack through the resident tick and the async pipeline on the card
against the same on the CPU. Every test here is marked `gpu` and skips
without a CUDA device; the file imports neither JAX nor the JAX package,
so on a machine without JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu_binpack.py

Outputs are integer or bool: the tolerance is exact equality.
"""
import numpy as np
import pytest
import torch

from swarmkit_tpu_torch.models import cluster_step as torch_cluster_step
from swarmkit_tpu_torch.ops import pipeline as torch_pipeline
from swarmkit_tpu_torch.ops import placement as torch_placement
from swarmkit_tpu_torch.ops import resident as torch_resident
from swarmkit_tpu_torch.scheduler import batch as torch_batch
from swarmkit_tpu_torch.scheduler import encode as torch_encode

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _problem(seed, n_nodes, n_groups, tasks, zero_cap=0.0):
    """The example cluster encoded for binpack, with seeded load,
    penalties, replica caps and (zero_cap) nodes with no room at all."""
    rng = np.random.RandomState(seed)
    infos, groups = torch_cluster_step.example_cluster(n_nodes, n_groups,
                                                       tasks, seed)
    p = torch_encode.encode(infos, groups, strategy="binpack")
    G, N = p.extra_mask.shape
    p.total0 = rng.randint(0, 40, N).astype(np.int32)
    p.svc_count0 = (rng.rand(*p.svc_count0.shape) < 0.3).astype(np.int32) \
        * rng.randint(1, 9, p.svc_count0.shape).astype(np.int32)
    p.penalty = rng.rand(G, N) < 0.05
    p.max_replicas = np.where(rng.rand(G) < 0.3, 3, 0).astype(np.int32)
    if zero_cap:
        p.avail_res = p.avail_res.copy()
        p.avail_res[rng.rand(N) < zero_cap] = 0
        p.need_res = np.maximum(p.need_res, 1).astype(np.int32)
    return p


def _args(p, device):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in torch_encode.kernel_args(p))


@pytest.mark.parametrize("seed, n_nodes, tasks, zero_cap", [
    (0, 900, 400, 0.0), (1, 900, 50, 0.5), (2, 5000, 2000, 0.1),
    (3, 20000, 300, 0.0)])
def test_binpack_kernel_matches_plain_and_oracle(cuda, seed, n_nodes, tasks,
                                                 zero_cap):
    p = _problem(seed, n_nodes, 8, tasks, zero_cap)
    before = torch_placement.binpack_fill_step.launches
    got = torch_placement.schedule_groups(*_args(p, cuda), strategy=1,
                                          device=cuda)
    want = torch_placement.schedule_groups(*_args(p, "cpu"), strategy=1,
                                           device="cpu")
    torch.cuda.synchronize()
    assert torch_placement.binpack_fill_step.launches \
        == before + p.extra_mask.shape[0]
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    if n_nodes <= 5000:
        np.testing.assert_array_equal(got[0].cpu().numpy(),
                                      torch_batch.cpu_schedule_encoded(p))


@pytest.mark.parametrize("n_nodes", [1, 300])
def test_binpack_step_edge_cases(cuda, n_nodes):
    """A group with no task, one whose quota is the whole capacity, one
    masked off everywhere, and a single node."""
    p = _problem(7, n_nodes, 6, 100)
    p.n_tasks = p.n_tasks.copy()
    p.n_tasks[0] = 0
    p.n_tasks[1] = 1 << 14
    p.extra_mask = p.extra_mask.copy()
    p.extra_mask[2] = False
    got = torch_placement.schedule_groups(*_args(p, cuda), strategy=1,
                                          device=cuda)
    want = torch_placement.schedule_groups(*_args(p, "cpu"), strategy=1,
                                           device="cpu")
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    np.testing.assert_array_equal(got[0].cpu().numpy(),
                                  torch_batch.cpu_schedule_encoded(p))


def _commit(infos):
    by_node = {i.node.id: i for i in infos}

    def commit(p, counts):
        orders = torch_batch.materialize_orders(p, counts)
        rows = [by_node[nid] for nid in p.node_ids]
        assert torch_batch.apply_wave(rows, p.groups, orders) \
            == int(counts.sum())
    return commit


def _waves(n_waves, n_groups, tasks):
    out = []
    for w in range(n_waves):
        _, groups = torch_cluster_step.example_cluster(1, n_groups, tasks, w)
        for g in groups:
            g.spec_version = w + 1
            for t in g.tasks:
                t.id = f"w{w}-{t.id}"
            g.ids = [t.id for t in g.tasks]
        out.append(groups)
    return out


@pytest.mark.parametrize("depth", [1, 3])
def test_binpack_async_pipeline_on_card_matches_cpu(cuda, depth):
    """Binpack waves of the flagship cluster through TickPipeline(
    async_commit=True) on the card and on the CPU: every wave equal, and
    equal to the oracle; the carried state and the counters equal."""
    res = {}
    for dev in (cuda, "cpu"):
        infos, _ = torch_cluster_step.example_cluster(600, 0, 0, 5)
        enc = torch_encode.IncrementalEncoder(strategy="binpack")
        rp = torch_resident.ResidentPlacement(enc, device=dev)
        pipe = torch_pipeline.TickPipeline(enc, rp, _commit(infos),
                                           depth=depth, async_commit=True)
        done = []
        try:
            for groups in _waves(5, 8, 60):
                done.extend(pipe.tick(infos, groups))
            done.extend(pipe.flush())
        finally:
            pipe.close()
        res[str(dev)] = (done, rp.pull_state(),
                         (rp.uploads_full, rp.uploads_delta_rows,
                          rp.uploads_group_tables, rp.uploads_h2d_bytes))
    (got, st_g, n_g), (want, st_w, n_w) = res["cuda"], res["cpu"]
    assert len(got) == len(want) == 5
    for (p, c), (_q, w) in zip(got, want):
        np.testing.assert_array_equal(c, w)
        np.testing.assert_array_equal(c, torch_batch.cpu_schedule_encoded(p))
    for k in st_g:
        np.testing.assert_array_equal(st_g[k], st_w[k], err_msg=k)
    assert n_g == n_w
