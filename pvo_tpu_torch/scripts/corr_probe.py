"""Where the correlation kernels' time goes on the card: variants and
ablations of ``csrc/corr.cu`` and ``csrc/corr_exp.cu`` built by text
substitution, timed in one process.

    python -m pvo_tpu_torch.scripts.corr_probe [variants] [ablate]
        [f32] [packed] [parent]

``variants`` rebuilds the source with other tuning constants (K3's ring
depth and blocks per SM, tile shape, product tile stride; K2's pixels
per block) and checks each against the plain version before timing it.
``ablate`` removes one part of the bf16 K3 at a time (its outputs are
then wrong: timing only). Both time K3's kernel alone on the backend's
chunk (E=256, 30x101, C=128, bf16, pyramid pooled beforehand, smooth
coordinates) and K2 at E=48. ``f32`` does the same for the f32 kernels
(three TF32 passes): K3 at the export's step (E=2, 47x156) and the
motion filter's probe (E=1, 30x101), K1 at the export's narrow shape
(E=2, 30x101), each kernel alone. ``packed`` does it for P1 and P2 at
their harness shapes (E=64 and E=32, 30x101): P1's two routes for a
bounding box over the cap, its store orders and rounding variants on
the harness's uniform coordinates and on smooth ones, kernel alone; P2's
pixels per block and its loads and stores switched off, beside the
sectors its loads touch. ``parent`` times the kernels of earlier
sources and of these in turns (parent, this, this, parent) in one
process, each kernel alone: the f32 kernels, K3 on bf16 features at
E=256 and K2 (whose outputs must equal the earlier ones bit for bit),
P1 and P2. The earlier sources are read from ``csrc/corr_parent.cu``
and ``csrc/corr_exp_parent.cu``, which git does not track; each holds
its own copy of the earlier header:

    for f in corr corr_exp; do
      (git show <commit>:pvo_tpu_torch/csrc/corr_common.cuh
       git show <commit>:pvo_tpu_torch/csrc/$f.cu |
         grep -v '#include "corr_common.cuh"') \
        > pvo_tpu_torch/csrc/${f}_parent.cu
    done

An earlier f32 K3 that takes no edge indices is given the gathered
frames (the gathers are outside the timed region). The substitutions
name lines of a source with the headers of ``csrc/`` written out in it
(:func:`expanded`): a line that changed there fails the assertion here,
and is brought up to date here.
"""

from __future__ import annotations

import ctypes
import re
import sys

import numpy as np
import torch

from pvo_tpu_torch.scripts import harness, kbench
from pvo_tpu_torch.vo.net import cuda_corr, cuda_corr_exp

C = 128
STAGES = "constexpr int K3T_STAGES = 2, K3T_BLOCKS_PER_SM = 2;"
TILE = "constexpr int K3T_TH = 8, K3T_TW = 16,"
STRIDE = "constexpr int K3T_LD = 72;"
K2_PIX = "constexpr int K2_PIX_PER_BLOCK = 8;"


def ring(stages, blocks):
    return (STAGES, f"constexpr int K3T_STAGES = {stages}, "
                    f"K3T_BLOCKS_PER_SM = {blocks};")


K3_VARIANTS = {
    "as committed": [],
    "ring 3, 1 block/SM": [ring(3, 1)],
    "ring 6, 1 block/SM": [ring(6, 1)],
    "ring 9, 1 block/SM": [ring(9, 1)],
    "tile 16x8": [(TILE, "constexpr int K3T_TH = 16, K3T_TW = 8,")],
    "product tile stride 68": [(STRIDE, "constexpr int K3T_LD = 68;")],
}
K2_VARIANTS = {
    "as committed": [],
    "4 pixels per block": [(K2_PIX, K2_PIX.replace("8", "4"))],
    "16 pixels per block": [(K2_PIX, K2_PIX.replace("8", "16"))],
}

# parts of the tensor-core K3, each switched off by one substitution
GATHER = ("if (!((ym >> r) & 1) || pr + PATCH <= n * K3T_BN ||",
          "if (true || !((ym >> r) & 1) || pr + PATCH <= n * K3T_BN ||")
STORE = ("      o[lane] = stage[qp * TAPS + lane];\n"
         "      if (lane + 32 < TAPS) o[lane + 32] = "
         "stage[qp * TAPS + lane + 32];\n", "")
BLEND = ("    if (t.live) {\n      float* o = stage + p * TAPS + half * 4;",
         "    if (false) {\n      float* o = stage + p * TAPS + half * 4;")
MMA = ("        for (int k = 0; k < C / 16; ++k)\n"
       "          wgmma_m64n64k16",
       "        for (int k = 0; k < 0; ++k)\n          wgmma_m64n64k16")
PRODUCTS = ("        for (int j = 0; j < K3T_BN / 8; ++j)\n#pragma unroll\n"
            "          for (int i = 0; i < 2; ++i) {\n"
            "            const int row = wg * 64",
            "        for (int j = 0; j < 0; ++j)\n#pragma unroll\n"
            "          for (int i = 0; i < 2; ++i) {\n"
            "            const int row = wg * 64")
LOADS = [("        if (t < nt)\n", "        if (false)\n"),
         ("        if (ahead < nt)\n", "        if (false)\n")]
ABLATIONS = {
    "whole kernel": [],
    "without the gather": [GATHER],
    "without the global store": [STORE],
    "without blend and store": [STORE, BLEND],
    "without the products": [MMA],
    "without products and their tile store": [MMA, PRODUCTS],
    "without the box loads": LOADS,
    "box loads alone": [GATHER, STORE, BLEND, MMA, PRODUCTS],
    "none of them (tile load, boxes, barriers)":
        [GATHER, STORE, BLEND, MMA, PRODUCTS, *LOADS],
}


# ---- the f32 kernels (three TF32 passes): K3's and K1's

def const(line, name, value):
    """``line`` (a constexpr definition of the source) with ``name``
    set to ``value``."""
    new, n = re.subn(rf"\b{name} = \d+", f"{name} = {value}", line)
    assert n == 1, (line, name)
    return (line, new)


K3F_CAP = "constexpr int K3F_BOX_CAP = 768, K3F_BLOCKS_PER_SM = 2;"
K1F_TILES = "constexpr int K1F_TILES = 8;"
K3F_VARIANTS = {
    "as committed": [],
    "box cap 384": [const(K3F_CAP, "K3F_BOX_CAP", 384)],
    "box cap 1536 (one block per SM)": [const(K3F_CAP, "K3F_BOX_CAP", 1536)],
}
K1F_VARIANTS = {
    "as committed": [],
    "4 tiles per block": [const(K1F_TILES, "K1F_TILES", 4)],
    "6 tiles per block": [const(K1F_TILES, "K1F_TILES", 6)],
    "16 tiles per block": [const(K1F_TILES, "K1F_TILES", 16)],
    "32 tiles per block": [const(K1F_TILES, "K1F_TILES", 32)],
}
# parts of the f32 K3, each switched off by one substitution
F_STORE = ("\n    o[lane] = stage[qp * TAPS + lane];\n"
           "    if (lane + 32 < TAPS) o[lane + 32] = "
           "stage[qp * TAPS + lane + 32];\n", "\n")
F_BLEND = ("  if (live) {\n    float* o = stage + p * TAPS + half * 4;",
           "  if (false) {\n    float* o = stage + p * TAPS + half * 4;")
F_GATHER = ("if (!((ym >> r) & 1) || pr + PATCH <= n * K3F_BN ||",
            "if (true || !((ym >> r) & 1) || pr + PATCH <= n * K3F_BN ||")
F_PRODUCTS = ("      for (int j = 0; j < K3F_BN / 8; ++j)",
              "      for (int j = 0; j < 0; ++j)")
F_MMA = ("\n      wgmma_tf32x3(d, dah, dal, dbh, dbl, C / 8);\n", "\n")
F_SPLIT = ("      store_chunks<K3F_THREADS>(pf, Bhi, Blo, 0, b_total);\n", "")
F_LOADS = ("    return p0 + r < np ? B + (size_t)rows[p0 + r] * C : nullptr;",
           "    return nullptr;")
# two of the three passes off, in K1 as well
ONE_PASS = ("  for (int k = 0; k < steps; ++k)\n"
            "    wgmma_k8(d, alo + 16 * k, bhi + 16 * k, k > 0);\n"
            "  for (int k = 0; k < steps; ++k) "
            "wgmma_k8(d, ahi + 16 * k, blo + 16 * k, 1);\n"
            "  for (int k = 0; k < steps; ++k) "
            "wgmma_k8(d, ahi + 16 * k, bhi + 16 * k, 1);\n",
            "  for (int k = 0; k < steps; ++k)\n"
            "    wgmma_k8(d, ahi + 16 * k, bhi + 16 * k, k > 0);\n")
K3F_ABLATIONS = {
    "whole kernel": [],
    "without the global store": [F_STORE],
    "without blend and store": [F_STORE, F_BLEND],
    "without the gather": [F_GATHER],
    "one TF32 pass instead of three": [ONE_PASS],
    "without the products": [F_MMA],
    "without products and their tile store": [F_MMA, F_PRODUCTS],
    "without the box tiles' split and store": [F_SPLIT],
    "without the box loads": [F_LOADS],
    "none of them (f1 tile, box, barriers)":
        [F_STORE, F_BLEND, F_GATHER, F_MMA, F_PRODUCTS, F_SPLIT, F_LOADS],
}
K1F_STORE = ("        *reinterpret_cast<uint4*>(V + (size_t)r * N2p + n0 + "
             "cj * 8) =\n"
             "            *reinterpret_cast<const uint4*>(O + r * (K1F_BN * 2) "
             "+\n"
             "                                            "
             "((cj ^ (r & 7)) * 16));\n", "        ;\n")
K1F_MMA = ("\n    wgmma_tf32x3(d, dah, dal, dbh, dbl, C / 8);\n", "\n")
K1F_SPLIT = ("    store_chunks<K1F_THREADS>(pf, Bhi, Blo, 0, b_total);\n", "")
K1F_LOADS = ("    return r0 + r < total ? base + (size_t)(r0 + r) * C : "
             "nullptr;", "    return nullptr;")
K1F_ABLATIONS = {
    "whole kernel": [],
    "without the global store": [K1F_STORE],
    "one TF32 pass instead of three": [ONE_PASS],
    "without the products": [K1F_MMA],
    "without the pyramid tiles' split and store": [K1F_SPLIT],
    "without the loads": [K1F_LOADS],
    "none of them": [K1F_STORE, K1F_MMA, K1F_SPLIT, K1F_LOADS],
}
# ---- the packed kernels (corr_exp.cu): P1's and P2's
P1_DENSE = ("constexpr bool P1_DENSE = true;",
            "constexpr bool P1_DENSE = false;")
P1_STORE = ("      *reinterpret_cast<uint4*>(o) = "
            "stage[qp * PATCH + (dy ^ (qp & 7))];",
            "      if (n_ch < 0) *reinterpret_cast<uint4*>(o) = "
            "stage[qp * PATCH + (dy ^ (qp & 7))];")
P1_VARIANTS = {
    "as committed (a box over the cap stays on the tensor cores)": [],
    "a box over the cap per pixel, as K3": [P1_DENSE],
    "without the global store": [P1_STORE],
}
P2_PIX = "constexpr int P2_PIX = 8;"
P2_VARIANTS = {
    "as committed": [],
    "4 pixels per block": [(P2_PIX, P2_PIX.replace("8", "4"))],
    "16 pixels per block": [(P2_PIX, P2_PIX.replace("8", "16"))],
}
# a condition that never holds at run time keeps the rest of the kernel
# from being compiled away with the loads or the store
P2_LOADS = [("      slot[0] = __ldg(src);\n",
             "      if (N2 < 0) slot[0] = __ldg(src);\n"),
            ("      slot[1] = __ldg(src + 1);\n",
             "      if (N2 < 0) slot[1] = __ldg(src + 1);\n")]
P2_STORE = ("    *reinterpret_cast<uint4*>(o_pix + l * PTAPS + r * PATCH) =\n",
            "    if (n_pix < 0)\n"
            "      *reinterpret_cast<uint4*>(o_pix + l * PTAPS + r * PATCH) "
            "=\n")
P2_ABLATIONS = {
    "whole kernel": [],
    "without the loads": P2_LOADS,
    "without the store": [P2_STORE],
    "neither (coords, blend, launch)": [*P2_LOADS, P2_STORE],
}
PARENT = cuda_corr.SOURCE.with_name("corr_parent.cu")
EXP_PARENT = cuda_corr_exp.SOURCE.with_name("corr_exp_parent.cu")
INCLUDE = re.compile(r'^#include "(\w+\.cuh)"\n', re.M)


def expanded(path, seen=None):
    """The CUDA source at ``path`` with every header of its directory
    written out where it is first included (and ``#pragma once``
    dropped): one text, so that a substitution can name a line of a
    header."""
    seen = set() if seen is None else seen

    def header(m):
        name = m.group(1)
        if name in seen:
            return ""
        seen.add(name)
        return expanded(path.with_name(name), seen)

    return INCLUDE.sub(header, path.read_text().replace("#pragma once\n", ""))


def load_built(module, path):
    """Build the source at ``path`` and make it the library that
    ``module``'s wrappers launch; returns it."""
    build = cuda_corr.build
    try:
        cuda_corr.build = lambda _=None: build(path)
        module._lib = None
        return module._library()
    finally:
        cuda_corr.build = build


def use(tag, subs, module=cuda_corr):
    """Build ``module``'s source (``corr.cu``, or ``corr_exp.cu`` for
    ``cuda_corr_exp``) with ``subs`` applied and make it the library the
    module's wrappers launch."""
    source = expanded(module.SOURCE)
    for old, new in subs:
        if source.count(old) != 1:
            raise AssertionError(f"{tag}: {old!r} is not a line of "
                                 f"{module.SOURCE.name}")
        source = source.replace(old, new)
    path = module.SOURCE.with_name(f"corr_probe_{abs(hash(tag))}.cu")
    path.write_text(source)
    try:
        load_built(module, path)
    finally:
        path.unlink()


def load_cudart():
    for name in ("libcudart.so", "libcudart.so.12", "libcudart.so.13"):
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    raise RuntimeError("no CUDA runtime library to load")


def features(E, seed):
    rng = np.random.RandomState(seed)
    return [torch.tensor(rng.randn(E, 30, 101, C), dtype=torch.float32)
            .cuda().bfloat16() for _ in range(2)]


class F32Case:
    """The f32 kernels' inputs at the shapes of their callers: K3 on
    frames + pyramid + edge indices (the export's step, E=2 at 47x156,
    and the probe, E=1 at 30x101; smooth coordinates), K1 on an E=2
    pooled pyramid at 30x101."""

    def __init__(self):
        self.k3 = {}
        for E, H, W in ((2, 47, 156), (1, 30, 101)):
            rng = np.random.RandomState(E + H)
            frames = torch.tensor(rng.randn(2 * E, H, W, C),
                                  dtype=torch.float32).cuda()
            ii = torch.arange(E, dtype=torch.int32, device="cuda")
            self.k3[E, H, W] = (
                frames, cuda_corr.lookup_pyramid(frames), ii, ii + E,
                torch.from_numpy(kbench.lookup_coords(
                    "smooth", E, H, W, seed=3)).cuda())
        # off the callers' case: level 0 (and 1) on the per-pixel route
        self.scattered = torch.from_numpy(kbench.lookup_coords(
            "scattered", 2, 47, 156, seed=3)).cuda()
        rng = np.random.RandomState(5)
        self.f1, f2 = (torch.tensor(rng.randn(2, 30, 101, C),
                                    dtype=torch.float32).cuda()
                       for _ in range(2))
        self.pyr = cuda_corr.pool_pyramid(f2)

    def k3_out(self, shape):
        return cuda_corr._launch_lookup(*self.k3[shape], 4)

    def k3_ms(self, shape, reps=50, queued=True):
        return kbench.device_time_ms(lambda: self.k3_out(shape), reps,
                                     queued)

    def k3_err(self, shape):
        frames, pyr, ii, jj, coords = self.k3[shape]
        return kbench.lookup_err(
            self.k3_out(shape), cuda_corr.corr_lookup_indexed_plain(
                frames, pyr, ii, jj, coords))

    def k1_out(self):
        return cuda_corr.build_volumes_pooled(self.f1, self.pyr)

    def k1_ms(self, reps=50, queued=True):
        return kbench.device_time_ms(self.k1_out, reps, queued)

    def library_ms(self, reps=50):
        """torch.bmm on K1's f32 operands (padded to the volume's
        stride): the yardstick, which the port never calls."""
        a = self.f1.reshape(2, -1, C) * cuda_corr.SCALE
        pad = cuda_corr.padded_n2(self.pyr.shape[1]) - self.pyr.shape[1]
        b = torch.nn.functional.pad(self.pyr, (0, 0, 0, pad)).transpose(1, 2)
        return kbench.device_time_ms(lambda: torch.bmm(a, b), reps, True)


def probe_f32():
    """Variants and ablations of the f32 kernels, each kernel alone and
    queued behind a busy card (``kbench.device_time_ms(queued=True)``:
    at these sizes the host enqueues slower than the card runs); the
    first line gives the committed kernels' times with the host in."""
    case = F32Case()
    step, probe = (2, 47, 156), (1, 30, 101)
    print(f"enqueued on an idle card: K3 f32 2x47x156 "
          f"{case.k3_ms(step, queued=False):.4f} ms, 1x30x101 "
          f"{case.k3_ms(probe, queued=False):.4f} ms, K1 f32 2x30x101 "
          f"{case.k1_ms(queued=False):.4f} ms", flush=True)
    for tag, subs in K3F_VARIANTS.items():
        use(tag, subs)
        err = max(case.k3_err(step), case.k3_err(probe))
        print(f"K3 f32 {tag}: max|d| {err:.3g}, 2x47x156 "
              f"{case.k3_ms(step):.4f} ms, 1x30x101 "
              f"{case.k3_ms(probe):.4f} ms", flush=True)
    ref = None
    for tag, subs in K1F_VARIANTS.items():
        use(tag, subs)
        out = case.k1_out()
        ref = out if ref is None else ref
        print(f"K1 f32 {tag}: equal to the committed kernel's "
              f"{torch.equal(out, ref)}, 2x30x101 {case.k1_ms():.4f} ms, "
              f"torch.bmm f32 {case.library_ms():.4f} ms", flush=True)
    for tag, subs in K3F_ABLATIONS.items():
        use(tag, subs)
        print(f"K3 f32 2x47x156 smooth, {tag}: {case.k3_ms(step):.4f} ms; "
              f"1x30x101: {case.k3_ms(probe):.4f} ms", flush=True)
    for tag, subs in K1F_ABLATIONS.items():
        use(tag, subs)
        print(f"K1 f32 2x30x101, {tag}: {case.k1_ms():.4f} ms", flush=True)


class PackedCase:
    """P1's and P2's inputs at their harness shapes (E=64 and E=32 at
    30x101, C=128, bf16): the harnesses' features, their uniform
    coordinates and smooth ones, P1's pyramid pooled beforehand (bf16;
    f32 for an earlier P1), K1's volume for P2."""

    def __init__(self, e1=64, e2=32, H=30, W=101):
        self.f1, f2, uniform = harness.harness_inputs(e1, H, W)
        self.pyr = cuda_corr.pool_pyramid(f2, dtype=torch.bfloat16)
        self.pyr32 = self.pyr.float()
        self.coords = {"uniform": uniform, "smooth": torch.from_numpy(
            kbench.lookup_coords("smooth", e1, H, W, seed=3)).cuda()}
        g1, g2, self.c2 = harness.harness_inputs(e2, H, W)
        self.vol = cuda_corr.build_volumes(g1, g2)
        self.c2_np = self.c2.cpu().numpy()
        self.saved = [t.cuda() for t in kbench.saved_extract_case()]

    def p1_out(self, kind="uniform", **kw):
        return cuda_corr_exp.corr_lookup_packed_pooled(
            self.f1, self.pyr, self.coords[kind], **kw)

    def p1_ms(self, kind, reps=20, **kw):
        return kbench.device_time_ms(lambda: self.p1_out(kind, **kw), reps)

    def p1_agreement(self, kind, **kw):
        """(share of outputs bit-equal to plain, max |d|) on the first
        two edges."""
        out = self.p1_out(kind, **kw)[:2].float()
        ref = cuda_corr_exp.corr_lookup_packed_plain(
            self.f1[:2], self.pyr_f2(), self.coords[kind][:2], **kw).float()
        return (out == ref).float().mean().item(), \
            (out - ref).abs().max().item()

    def pyr_f2(self):
        """The first two edges' f2 (level 0 of the pyramid)."""
        E, H, W, C = self.f1.shape
        return self.pyr[:2, :H * W].reshape(2, H, W, C)

    def p2_out(self, **kw):
        return cuda_corr_exp.corr_extract_packed(self.vol, self.c2, **kw)

    def p2_ms(self, reps=50, queued=False, **kw):
        return kbench.device_time_ms(lambda: self.p2_out(**kw), reps, queued)

    def p2_sha(self):
        return kbench.fingerprint(
            cuda_corr_exp.corr_extract_packed(*self.saved))


def p2_bound_line(case):
    """P2's two bounds at the case's shape: counted bytes, and the
    32-byte sectors its loads touch on the case's coordinates."""
    E, H, W, _ = case.c2.shape
    b = kbench.kernel_bound("corr_extract_packed", E, H, W, C,
                            coords=case.c2_np)
    return (f"bound {b['ms']:.4f} ms by bytes, {b['sector_ms']:.4f} ms by "
            f"sectors ({b['sectors'] / (E * H * W):.2f} sectors a pixel)")


def probe_packed():
    """P1's and P2's variants and ablations, each kernel alone."""
    case = PackedCase()
    E, H, W, _ = case.f1.shape
    b1 = kbench.kernel_bound("corr_lookup_packed", E, H, W, C)["ms"]
    for kind, c in case.coords.items():
        print(f"P1 {E}x{H}x{W} {kind} coords: expected (block, level) pairs "
              f"within / above the cap "
              f"{cuda_corr_exp.expected_routes(c.cpu().numpy(), H, W)}",
              flush=True)
    for tag, subs in P1_VARIANTS.items():
        use(tag, subs, cuda_corr_exp)
        agree = ("" if "without" in tag else
                 " bit-equal {:.6f} max|d| {:.3g};".format(
                     *case.p1_agreement("uniform")))
        print(f"P1 {tag}:{agree} " + ", ".join(
            f"{kind} {case.p1_ms(kind):.4f} ms" for kind in case.coords) +
            f"; bound {b1:.4f} ms", flush=True)
    use("as committed", [], cuda_corr_exp)
    for kw in (dict(order=o, seldt=s) for o in cuda_corr_exp.ORDERS
               for s in cuda_corr_exp.SELDT):
        print(f"P1 {kw}: " + ", ".join(
            "{} {:.4f} ms (bit-equal {:.6f})".format(
                kind, case.p1_ms(kind, **kw),
                case.p1_agreement(kind, **kw)[0])
            for kind in case.coords), flush=True)
    print(f"P2 {'x'.join(map(str, case.c2.shape[:3]))}: "
          f"{p2_bound_line(case)}", flush=True)
    for tag, subs in P2_VARIANTS.items():
        use(tag, subs, cuda_corr_exp)
        same = case.p2_sha() == kbench.SAVED_EXTRACT_PACKED_SHA256
        print(f"P2 {tag}: bit-equal to the saved case {same}, "
              f"{case.p2_ms():.4f} ms", flush=True)
    for tag, subs in P2_ABLATIONS.items():
        use(tag, subs, cuda_corr_exp)
        print(f"P2 {tag}: {case.p2_ms():.4f} ms", flush=True)
    use("as committed", [], cuda_corr_exp)


def parent_packed_library():
    """The earlier ``corr_exp.cu``: P1 with its earlier C interface (f32
    or bf16 features on an f32 pyramid, pixels in a row), P2 as now."""
    lib = ctypes.CDLL(str(cuda_corr.build(EXP_PARENT)))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ip = ctypes.POINTER(ctypes.c_int)
    lib.pvo_corr_lookup_packed.argtypes = [p, i, p, p, p, i, i, i, i, f, i,
                                           ip, i, i, p]
    lib.pvo_corr_extract_packed.argtypes = [p, p, p, i, i, i, ip, i, i, i, p]
    for fn in (lib.pvo_corr_lookup_packed, lib.pvo_corr_extract_packed):
        fn.restype = ctypes.c_int
    return lib


def parent_lookup_packed(lib, f1, pyr32, coords):
    """The earlier P1 alone (level-major, f32 intermediates)."""
    E, H, W, width = f1.shape
    out = torch.empty((E, H, W, 4 * cuda_corr_exp.PTAPS),
                      dtype=torch.bfloat16, device=f1.device)
    rc = lib.pvo_corr_lookup_packed(
        f1.data_ptr(), 1, pyr32.data_ptr(), coords.data_ptr(),
        out.data_ptr(), H * W, E * H * W, pyr32.shape[1], width,
        cuda_corr.SCALE, 4,
        cuda_corr.level_array(cuda_corr.level_shapes(H, W)), 0, 0,
        torch.cuda.current_stream().cuda_stream)
    cuda_corr.check_rc(rc, "the earlier corr_lookup_packed")
    return out


def parent_vs_change_packed():
    """P1 and P2 of ``csrc/corr_exp_parent.cu`` and of ``corr_exp.cu`` in
    turns, each kernel alone."""
    if not EXP_PARENT.exists():
        raise SystemExit(f"{EXP_PARENT} is missing: see this module's "
                         f"docstring")
    libs = {"parent": parent_packed_library(),
            "change": load_built(cuda_corr_exp, cuda_corr_exp.SOURCE)}
    case = PackedCase()
    order = ("parent", "change", "change", "parent")

    def p1(tag, kind):
        if tag == "parent":
            return kbench.device_time_ms(lambda: parent_lookup_packed(
                libs[tag], case.f1, case.pyr32, case.coords[kind]), 10)
        return case.p1_ms(kind)

    def p2(tag, **kw):
        cuda_corr_exp._lib = libs[tag]
        return case.p2_ms(**kw)

    E, H, W, _ = case.f1.shape
    b1 = kbench.kernel_bound("corr_lookup_packed", E, H, W, C)["ms"]
    for kind in case.coords:
        print(f"P1 {E}x{H}x{W} {kind} coords, kernel alone: " + ", ".join(
            f"{tag} {p1(tag, kind):.4f} ms" for tag in order) +
            f"; bound {b1:.4f} ms", flush=True)
    print(f"P2 {'x'.join(map(str, case.c2.shape[:3]))}, full: " + ", ".join(
        f"{tag} {p2(tag):.4f} ms" for tag in order) +
        f"; {p2_bound_line(case)}", flush=True)
    # novab and dma run under the 40 us the host takes to enqueue a call
    for mode in cuda_corr_exp.MODES[1:]:
        print(f"P2 {mode}, queued behind a busy card: " + ", ".join(
            f"{tag} {p2(tag, mode=mode, queued=True):.4f} ms"
            for tag in order), flush=True)
    for tag in libs:
        cuda_corr_exp._lib = libs[tag]
        print(f"P2 {tag}: sha256 of the saved case {case.p2_sha()}",
              flush=True)
    cuda_corr_exp._lib = libs["change"]


def parent_vs_change_bf16(libs):
    """K3 on bf16 features (the backend's chunk, E=256 at 30x101, smooth
    coordinates, kernel alone) of both sources in turns; K3's outputs on
    every kind of coordinates and K2's on the saved case must be the
    earlier source's bit for bit."""
    f = features(256, 256)
    pyr = cuda_corr.lookup_pyramid(f[1])
    c = coords("smooth", 256)

    def k3(tag, E=256, c=c):
        cuda_corr._lib = libs[tag]
        return cuda_corr._launch_lookup(f[0][:E], pyr[:E], None, None, c, 4)

    print("K3 bf16 256x30x101 smooth, kernel alone: " + ", ".join(
        f"{tag} {kbench.device_time_ms(lambda: k3(tag), 20):.4f} ms"
        for tag in ("parent", "change", "change", "parent")), flush=True)
    same = {kind: torch.equal(
        *(k3(tag, 48, coords(kind, 48)).nan_to_num(nan=-7.0)
          for tag in libs)) for kind in kbench.LOOKUP_COORDS}
    saved = [t.cuda() for t in kbench.saved_extract_case()]
    sha = {}
    for tag in libs:
        cuda_corr._lib = libs[tag]
        sha[tag] = kbench.fingerprint(cuda_corr.corr_extract(*saved))
    print(f"K3 bf16 48x30x101 equal to the parent's, bit for bit: {same}; "
          f"K2 saved case: parent "
          f"{sha['parent'] == kbench.SAVED_EXTRACT_SHA256}, change "
          f"{sha['change'] == kbench.SAVED_EXTRACT_SHA256}", flush=True)
    if not (all(same.values()) and sha["parent"] == sha["change"]):
        raise AssertionError("K3 or K2 differs from the earlier source's")


def parent_vs_change():
    """The kernels of ``csrc/corr_parent.cu`` and of ``corr.cu`` in
    turns, each kernel alone: K3 on bf16 features and K2's fingerprint,
    then the f32 kernels queued behind a busy card."""
    if not PARENT.exists():
        raise SystemExit(f"{PARENT} is missing: see this module's docstring")
    libs = {tag: load_built(cuda_corr, path)
            for tag, path in (("parent", PARENT),
                              ("change", cuda_corr.SOURCE))}
    parent_vs_change_bf16(libs)
    # an earlier f32 K3 that refuses edge indices reads gathered frames
    case = F32Case()
    cuda_corr._lib = libs["parent"]
    try:
        case.k3_out((1, 30, 101))
        gathers = False
    except RuntimeError:
        gathers = True
    print(f"parent's f32 K3 takes edge indices: {not gathers}", flush=True)
    gathered = {shape: (fr[i.long()].contiguous(), py[j.long()].contiguous(),
                        None, None, c)
                for shape, (fr, py, i, j, c) in case.k3.items()}

    def k3(tag, shape, coords=None):
        cuda_corr._lib = libs[tag]
        args = gathered[shape] if tag == "parent" and gathers \
            else case.k3[shape]
        args = args if coords is None else (*args[:4], coords)
        return kbench.device_time_ms(
            lambda: cuda_corr._launch_lookup(*args, 4), 50, queued=True)

    def k1(tag):
        cuda_corr._lib = libs[tag]
        return case.k1_ms()

    def k3_wrapper(tag, shape):
        """The indexed entry as a caller meets it, on an idle card: the
        earlier one gathered the edges' frames and pyramids per call."""
        cuda_corr._lib = libs[tag]
        fr, py, i, j, c = case.k3[shape]
        if tag == "parent" and gathers:
            return kbench.device_time_ms(
                lambda: cuda_corr._launch_lookup(
                    fr[i.long()], py[j.long()], None, None, c, 4), 50)
        return kbench.device_time_ms(
            lambda: cuda_corr.corr_lookup_indexed(fr, py, i, j, c), 50)

    order = ("parent", "change", "change", "parent")
    for shape in case.k3:
        print(f"K3 f32 {'x'.join(map(str, shape))} smooth, kernel alone: " +
              ", ".join(f"{tag} {k3(tag, shape):.4f} ms" for tag in order),
              flush=True)
        print(f"K3 f32 {'x'.join(map(str, shape))} smooth, around the "
              f"wrapper: " + ", ".join(
                  f"{tag} {k3_wrapper(tag, shape):.4f} ms" for tag in order),
              flush=True)
    print("K3 f32 2x47x156 scattered, kernel alone: " + ", ".join(
        f"{tag} {k3(tag, (2, 47, 156), case.scattered):.4f} ms"
        for tag in order), flush=True)
    print("K1 f32 2x30x101, kernel alone: " +
          ", ".join(f"{tag} {k1(tag):.4f} ms" for tag in order) +
          f"; torch.bmm f32 {case.library_ms():.4f} ms", flush=True)
    cuda_corr._lib = libs["change"]


def coords(kind, E):
    return torch.from_numpy(
        kbench.lookup_coords(kind, E, 30, 101, seed=3)).cuda()


def main(argv=None):
    kbench.require_cuda()
    what = (sys.argv[1:] if argv is None else argv) or ["variants", "ablate"]
    if "parent" in what:
        parent_vs_change()
        parent_vs_change_packed()
    if "f32" in what:
        probe_f32()
    if "packed" in what:
        probe_packed()
    if not {"variants", "ablate"} & set(what):
        use("as committed", [])
        print(kbench.gpu_line())
        return
    f48, f256 = features(48, 48), features(256, 256)
    pyr48, pyr256 = (cuda_corr.lookup_pyramid(f[1]) for f in (f48, f256))

    def lookup(f, pyr, c):
        return cuda_corr._launch_lookup(f[0], pyr, None, None, c, 4)

    def k3_ms(kind):
        c = coords(kind, 256)
        return kbench.device_time_ms(lambda: lookup(f256, pyr256, c), 20)

    if "variants" in what:
        ref = {k: cuda_corr.corr_lookup_plain(*f48, coords(k, 48))
               for k in ("smooth", "scattered")}
        for tag, subs in K3_VARIANTS.items():
            use(tag, subs)
            err = max(kbench.lookup_err(lookup(f48, pyr48, coords(k, 48)),
                                        ref[k]) for k in ref)
            print(f"K3 {tag}: max|d| {err:.3g}, E=256 smooth "
                  f"{k3_ms('smooth'):.4f} ms, scattered "
                  f"{k3_ms('scattered'):.4f} ms", flush=True)
        vol = cuda_corr.build_volumes(*f48)
        saved = [t.cuda() for t in kbench.saved_extract_case()]
        c48 = coords("smooth", 48)
        for tag, subs in K2_VARIANTS.items():
            use(tag, subs)
            same = kbench.fingerprint(cuda_corr.corr_extract(*saved)) == \
                kbench.SAVED_EXTRACT_SHA256
            ms = kbench.device_time_ms(
                lambda: cuda_corr.corr_extract(vol, c48), 20)
            print(f"K2 {tag}: bit-equal to the saved case {same}, E=48 "
                  f"{ms:.4f} ms", flush=True)
        # the L2's fetch granularity (cudaLimitMaxL2FetchGranularity = 5)
        rt = load_cudart()
        was = ctypes.c_size_t()
        rt.cudaDeviceGetLimit(ctypes.byref(was), 5)
        rc = rt.cudaDeviceSetLimit(5, ctypes.c_size_t(32))
        ms = kbench.device_time_ms(
            lambda: cuda_corr.corr_extract(vol, c48), 20)
        print(f"K2 with the L2 fetch granularity asked down from "
              f"{was.value} to 32 bytes (rc {rc}): {ms:.4f} ms", flush=True)
        rt.cudaDeviceSetLimit(5, was)
    if "ablate" in what:
        for tag, subs in ABLATIONS.items():
            use(tag, subs)
            print(f"K3 E=256 smooth, {tag}: {k3_ms('smooth'):.4f} ms",
                  flush=True)
    use("as committed", [])
    print(kbench.gpu_line())


if __name__ == "__main__":
    main()
