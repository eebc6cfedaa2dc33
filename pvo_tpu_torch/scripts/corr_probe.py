"""Where K3's and K2's time goes on the card: variants and ablations of
``csrc/corr.cu`` built by text substitution, timed in one process.

    python -m pvo_tpu_torch.scripts.corr_probe [variants] [ablate]

``variants`` rebuilds the source with other tuning constants (K3's ring
depth and blocks per SM, tile shape, product tile stride; K2's pixels
per block) and checks each against the plain version before timing it.
``ablate`` removes one part of the tensor-core K3 at a time (its
outputs are then wrong: timing only). Both time K3's kernel alone on
the backend's chunk (E=256, 30x101, C=128, bf16, pyramid pooled
beforehand, smooth coordinates) and K2 at E=48. The substitutions name
lines of the source: a line that changed there fails the assertion
here, and is brought up to date here.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from pvo_tpu_torch.scripts import kbench
from pvo_tpu_torch.vo.net import cuda_corr

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
BLEND = ("    if (live) {\n      float* o = stage + p * TAPS + half * 4;",
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


def use(tag, subs, source=cuda_corr.SOURCE.read_text(),
        build=cuda_corr.build):
    """Build ``corr.cu`` with ``subs`` applied and make it the library
    the wrappers launch."""
    for old, new in subs:
        if source.count(old) != 1:
            raise AssertionError(f"{tag}: {old!r} is not a line of corr.cu")
        source = source.replace(old, new)
    path = cuda_corr.SOURCE.with_name(f"corr_probe_{abs(hash(tag))}.cu")
    path.write_text(source)
    try:
        cuda_corr.build = lambda _=None: build(path)
        cuda_corr._lib = None
        cuda_corr._library()
    finally:
        cuda_corr.build = build
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


def coords(kind, E):
    return torch.from_numpy(
        kbench.lookup_coords(kind, E, 30, 101, seed=3)).cuda()


def main(argv=None):
    kbench.require_cuda()
    what = (sys.argv[1:] if argv is None else argv) or ["variants", "ablate"]
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
