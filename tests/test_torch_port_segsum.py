"""The fixed-order segment sum (``vo/net/cuda_segsum.py``, B5's repair).

On the CPU: the wrapper's plain route against ``Tensor.index_add_`` on
the in-range rows, bit for bit, at the shapes of its call sites (GraphAgg
and its counts, the chunked backend update, the DBA's Hessian, gradient,
Schur and depth sums); GraphAgg's scatter-mean and its gradient against
``index_add_``'s; and the sum against the JAX package's
``jax.ops.segment_sum`` within 1e-6.

On the card (``cuda`` marker, skipped here): the kernel bit-equal to the
CPU's ``index_add_`` at the same shapes, and two runs of 20 tracked
frames of the ``bench_track`` stream bit-equal on the classic path and
on the planner. The file imports JAX only inside its JAX case, so on a
machine with only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_port_segsum.py -q
"""

import numpy as np
import pytest
import torch

from pvo_tpu_torch.vo.net import cuda_segsum
from pvo_tpu_torch.vo.net.update import GraphAgg

from torch_one_thread import one_thread  # noqa: F401

# (rows, segments, trailing shape) of each call site at a small size
# (h, w = 4, 6; E = 12 edges, K = P = 8): GraphAgg's sums and counts,
# the chunked update's, the DBA's H (4E rows into P*P+1), v (2E into
# P+1), C / w / Ei (E into K), the Schur terms (K + 2E, then pairs, into
# P*P+1) and the rhs correction (K + E into P+1)
SITES = {
    "graph_agg": (12, 8, (128, 4, 6)),
    "graph_agg_counts": (12, 8, ()),
    "chunked_update": (12, 9, (128, 4, 6)),
    "dba_hessian": (48, 65, (6, 6)),
    "dba_gradient": (24, 9, (6,)),
    "dba_depth": (12, 8, (24,)),
    "dba_ei": (12, 8, (6, 24)),
    "dba_schur": (32, 65, (6, 6)),
    "dba_pairs": (300, 65, (6, 6)),
    "dba_rhs": (20, 9, (6,)),
}


def site_inputs(name, seed=0, device="cpu"):
    n, n_out, shape = SITES[name]
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n,) + shape, generator=g)
    # about a tenth of the rows out of range on either side
    idx = torch.randint(-1, n_out + 1, (n,), generator=g)
    out = torch.randn((n_out,) + shape, generator=g)
    return tuple(t.to(device) for t in (out, idx, x))


def reference(out, idx, x):
    ok = (idx >= 0) & (idx < out.shape[0])
    return out.clone().index_add_(0, idx[ok], x[ok])


@pytest.mark.parametrize("name", sorted(SITES))
def test_plain_route_is_index_add(name):
    out, idx, x = site_inputs(name)
    want = reference(out, idx, x)
    got = cuda_segsum.index_add(out.clone(), idx, x)
    assert torch.equal(got, want)
    seg = cuda_segsum.segment_sum(x, idx, out.shape[0])
    assert torch.equal(seg, reference(torch.zeros_like(out), idx, x))


def test_scatter_mean_and_its_gradient():
    """GraphAgg's scatter-mean through SegmentSum against the
    index_add_ it replaced (an extra row for the dropped edges), values
    and gradient bit for bit."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(10, 128, 4, 6, generator=g)
    ids = torch.tensor([0, 1, 1, 3, 5, 5, 5, 2, 6, 0])  # 6 == K: dropped
    K = 6
    x1 = x.clone().requires_grad_()
    got = GraphAgg.scatter_mean(x1, ids, K)
    x2 = x.clone().requires_grad_()
    summed = torch.zeros((K + 1,) + x.shape[1:]).index_add(0, ids, x2)
    counts = torch.zeros(K + 1).index_add_(0, ids, torch.ones(10))
    want = summed[:K] / counts[:K].clamp(min=1.0)[:, None, None, None]
    assert torch.equal(got, want)
    mean, n = GraphAgg.scatter_mean_counts(x, ids, K)
    assert torch.equal(mean, want.detach())
    assert torch.equal(n, counts[:K])
    w = torch.randn(want.shape, generator=g)
    (got * w).sum().backward()
    (want * w).sum().backward()
    assert torch.equal(x1.grad, x2.grad)


def test_segment_sum_matches_jax():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    out, idx, x = site_inputs("dba_pairs", seed=2)
    n = out.shape[0]
    ids = np.where((idx.numpy() >= 0) & (idx.numpy() < n), idx.numpy(), n)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(x.numpy()),
                                          jnp.asarray(ids),
                                          num_segments=n + 1))[:n]
    got = cuda_segsum.segment_sum(x, idx, n).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_bound_counts_the_rows_it_adds():
    """kbench.segsum_bound: the rows added, the index and the output read
    once, the output written once; one f32 add a value."""
    from pvo_tpu_torch.scripts import kbench
    b = kbench.segsum_bound(40, 48, 32, 100)
    assert b["bytes"] == 40 * 100 * 4 + 48 * 8 + 2 * 32 * 100 * 4
    assert b["flops"] == 40 * 100
    assert b["bound_by"] == "bytes"
    assert b["ms"] == pytest.approx(1e3 * b["bytes"] / kbench.HBM_BYTES_S)


# ------------------------------------------------------------ the card

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SITES))
def test_kernel_is_the_cpus_index_add(dev, name):
    out, idx, x = site_inputs(name, seed=3)
    want = cuda_segsum.index_add(out.clone(), idx, x)
    n = cuda_segsum.LAUNCHES["segsum"]
    got = cuda_segsum.index_add(out.to(dev), idx.to(dev), x.to(dev))
    assert cuda_segsum.LAUNCHES["segsum"] == n + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["classic", "planner"])
def test_tracking_repeats_itself(dev, pipeline):
    """B5: two runs of the same 20 frames give bit-equal keyframe poses
    and disparities (they parted at frame 12 when the sums were
    atomics)."""
    from pvo_tpu_torch.scripts.bench_track import bench_system, synth_stream

    def run():
        sysm = bench_system((240, 808), 64, dev, pipeline=pipeline)
        for t, img, intr, segm in synth_stream(20, 240, 808):
            sysm.track(t, img, intr, segments=segm)
        engaged = sysm.planner.engaged
        traj = sysm.get_traj()
        n = sysm.video.counter
        return engaged, traj, sysm.video.disps[:n].cpu()

    (e1, p1, d1), (e2, p2, d2) = run(), run()
    assert e1 == e2 == pipeline
    assert np.array_equal(p1, p2)
    assert torch.equal(d1, d2)
