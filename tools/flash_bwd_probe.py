"""Variants of K5 bwd's float32 kernels on the card: each a copy of the
source with a few lines replaced, all built at once (one ``nvcc`` each),
their float32 kernels' registers, spill bytes and stack frames printed
from ptxas; then each checked against the plain backward and timed in a
process of its own, in the order above and then back.

    python tools/flash_bwd_probe.py

The variants (``VARIANTS``):

* ``base``: the source as it stands;
* ``s_slice_sums``: S^T (S) summed from zero a 16-column slice at a time
  and added in float32, as dP^T (dP) is, so that no accumulator chain is
  longer than six products;
* ``fused``: the slice loops of the two first products merged into one;
* ``dkdv_unroll2``: the dK/dV kernel's first-product slice loops
  unrolled by 2 (the dQ kernel's are).

Checks (float32, N(0, 1) inputs, the tree's own forward's output and
logsumexp): dq, dk, dv within 1e-5 relative L2 of
``flash_attention_gqa_bwd_ref`` (a lone key's dq and dk, 0 by
construction, by their largest entry), two calls bitwise alike, at
[23a]'s shapes and at tile, window and ragged edges.  Times: ms a call
(CUDA events, 10 calls after a warm-up, three runs) at (1, 2048, 24/8,
128) causal and with a window of 1,024, (1, 4096, 24/8, 64) and (2, 512,
4/2, 16), each kernel's device ms from one profiled call, and in the
first process SDPA's backward as ``chip_smoke.py`` [23a] times it.  The
trees are made under ``build/var/`` (git-ignored); the log goes to
standard output.
"""
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (B, S, H, KV, dh), causal, window
CHECKS = [((1, 2048, 24, 8, 128), True, None),
          ((1, 2048, 24, 8, 128), True, 1024),
          ((1, 4096, 24, 8, 64), True, None), ((2, 512, 4, 2, 16), True, None),
          ((1, 1000, 6, 2, 64), True, 1), ((1, 1000, 6, 2, 64), True, 100),
          ((1, 1000, 6, 2, 64), True, 1000), ((2, 1, 6, 2, 128), True, None),
          ((1, 257, 6, 2, 128), True, 1), ((1, 300, 6, 2, 128), False, None),
          ((1, 300, 8, 2, 16), False, None), ((1, 383, 6, 2, 128), True, 65)]
# (B, S, H, KV, dh), window; causal
TIMED = [((1, 2048, 24, 8, 128), None), ((1, 2048, 24, 8, 128), 1024),
         ((1, 4096, 24, 8, 64), None), ((2, 512, 4, 2, 16), None)]


# substitutions (old, new) of the committed source
S_SUMS = ("mma3_slice<kNB, kLdB, false>", "mma3_slice<kNB, kLdB, true>")
KV = """#pragma unroll
      for (int i = 0; i < D / 16; ++i)
        mma3_slice<kNB, kLdB, false>(
            st, *reinterpret_cast<const float4*>(k_rows + 16 * i),
            *reinterpret_cast<const float4*>(k_rows + 8 * kLdA + 16 * i),
            qs + b_first + 16 * i);
#pragma unroll
      for (int i = 0; i < D / 16; ++i)
        mma3_slice<kNB, kLdB, true>(
            dpt, *reinterpret_cast<const float4*>(v_rows + 16 * i),
            *reinterpret_cast<const float4*>(v_rows + 8 * kLdA + 16 * i),
            dos + b_first + 16 * i);
"""
KV_F = """#pragma unroll
      for (int i = 0; i < D / 16; ++i) {
        mma3_slice<kNB, kLdB, true>(
            st, *reinterpret_cast<const float4*>(k_rows + 16 * i),
            *reinterpret_cast<const float4*>(k_rows + 8 * kLdA + 16 * i),
            qs + b_first + 16 * i);
        mma3_slice<kNB, kLdB, true>(
            dpt, *reinterpret_cast<const float4*>(v_rows + 16 * i),
            *reinterpret_cast<const float4*>(v_rows + 8 * kLdA + 16 * i),
            dos + b_first + 16 * i);
      }
"""
Q = """#pragma unroll 2
      for (int i = 0; i < D / 16; ++i)
        mma3_slice<kNB, kLdB, false>(
            sc, *reinterpret_cast<const float4*>(q_rows + 16 * i),
            *reinterpret_cast<const float4*>(q_rows + 8 * kLdA + 16 * i),
            ks + b_first + 16 * i);
#pragma unroll 2
      for (int i = 0; i < D / 16; ++i)
        mma3_slice<kNB, kLdB, true>(
            dp, *reinterpret_cast<const float4*>(do_rows + 16 * i),
            *reinterpret_cast<const float4*>(do_rows + 8 * kLdA + 16 * i),
            vs + b_first + 16 * i);
"""
Q_F = """#pragma unroll 2
      for (int i = 0; i < D / 16; ++i) {
        mma3_slice<kNB, kLdB, true>(
            sc, *reinterpret_cast<const float4*>(q_rows + 16 * i),
            *reinterpret_cast<const float4*>(q_rows + 8 * kLdA + 16 * i),
            ks + b_first + 16 * i);
        mma3_slice<kNB, kLdB, true>(
            dp, *reinterpret_cast<const float4*>(do_rows + 16 * i),
            *reinterpret_cast<const float4*>(do_rows + 8 * kLdA + 16 * i),
            vs + b_first + 16 * i);
      }
"""
LOOP = "\n      for (int i = 0; i < D / 16; ++i)\n        mma3_slice"
U = ("#pragma unroll" + LOOP, "#pragma unroll 2" + LOOP)
VARIANTS = {
    "base": [],
    "s_slice_sums": [S_SUMS],
    "fused": [(KV, KV_F), (Q, Q_F)],
    "dkdv_unroll2": [U],
}


def make(name, subs):
    """A copy of src/ under build/var/NAME with ``subs`` applied to the
    backward's source."""
    tree = ROOT / "build/var" / name
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(ROOT / "src", tree / "src")
    f = tree / "src/repro_torch/kernels/flashattn/csrc/flashattn_bwd.cu"
    t = f.read_text()
    for old, new in subs:
        assert old in t, (name, old)
        t = t.replace(old, new)
    f.write_text(t)
    return tree


def build(tree):
    """A child that builds ``tree``'s backward library."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "from repro_torch.kernels.flashattn import kernel as fk;"
            "fk.bwd_library()")
    return subprocess.Popen([sys.executable, "-c", code, str(tree / "src")])


def report(name, tree):
    """Registers / spill stores / stack frame of each float32 kernel."""
    reps = list((tree / "build/kernels").glob("flashattn_bwd-*.ptxas"))
    rep = reps[0].read_text().splitlines()
    spill, out = 0, []
    for i, line in enumerate(rep):
        if "Compiling entry" in line and "tf32" in line:
            k = re.search(r"(bwd_\w+?_kernelILi\d+ELb\d)", line).group(1)
            props = " ".join(rep[i + 1:i + 4])
            regs = re.search(r"Used (\d+) registers", props).group(1)
            st = int(re.search(r"(\d+) bytes spill stores", props).group(1))
            sf = int(re.search(r"(\d+) bytes stack frame", props).group(1))
            spill += st
            out.append(f"{k[4:]}:{regs}/{st}/{sf}")
    print(f"{name}: spill stores {spill}; " + " ".join(out), flush=True)


def run_tree(tree, label, sdpa):
    """Check and time ``tree``'s backward (run in a child)."""
    sys.path[:0] = [str(Path(tree).resolve() / "src"), str(ROOT)]
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels.flashattn import kernel as fk
    from repro_torch.kernels.flashattn import flash_attention_gqa_bwd_ref
    import chip_smoke as cs
    fk.library()
    fk.bwd_library()
    bad = []
    for shape, causal, window in CHECKS:
        b, s, h, kv, dh = shape
        q, k, v = cs.flash_inputs(shape, torch.float32, 52 + s)
        g = torch.Generator(device="cuda").manual_seed(1052 + s)
        do = torch.randn((b, s, h, dh), generator=g, device="cuda")
        out, lse = fk.flash_attention_cuda(q, k, v, causal=causal,
                                           window=window, return_lse=True)
        got = fk.flash_attention_bwd_cuda(q, k, v, out, lse, do,
                                          causal=causal, window=window)
        again = fk.flash_attention_bwd_cuda(q, k, v, out, lse, do,
                                            causal=causal, window=window)
        want = flash_attention_gqa_bwd_ref(q, k, v, out, lse, do,
                                           causal=causal, window=window)
        lone = window == 1 or s == 1
        errs = [float((x - y).abs().max()) if lone and i < 2
                else cs.rel_l2(x, y)
                for i, (x, y) in enumerate(zip(got, want))]
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        ok = same and max(errs) <= 1e-5
        if not ok:
            bad.append(shape)
        print(f"{label} check {shape} causal {causal} window {window}: "
              f"{', '.join(f'{e:.3g}' for e in errs)} same {same}"
              f"{'' if ok else '  FAIL'}", flush=True)
        del q, k, v, do, out, lse, got, again, want
    for shape, window in TIMED:
        b, s, h, kv, dh = shape
        q, k, v = cs.flash_inputs(shape, torch.float32, 52)
        g = torch.Generator(device="cuda").manual_seed(1052)
        do = torch.randn((b, s, h, dh), generator=g, device="cuda")
        out, lse = fk.flash_attention_cuda(q, k, v, window=window,
                                           return_lse=True)
        ms = [cs.cuda_time_ms(lambda: fk.flash_attention_bwd_cuda(
            q, k, v, out, lse, do, window=window), 10) for _ in range(3)]
        n_bytes, n_ops = cs.bwd_cost(shape, True, 4, window)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as pr:
            fk.flash_attention_bwd_cuda(q, k, v, out, lse, do, window=window)
            torch.cuda.synchronize()
        prof = ", ".join(
            f"{re.search(r'bwd_[a-z0-9_]+', e.key).group(0)} "
            f"{e.device_time_total / 1e3:.3f}"
            for e in pr.key_averages() if "bwd_" in e.key)
        lib = ""
        if sdpa:
            lib_ms = cs.sdpa_bwd_ms(q, k, v, do, True, window, 10)
            lib = f"; SDPA {lib_ms:.3f}"
        print(f"{label} time {shape} window {window}: "
              f"{', '.join(f'{x:.3f}' for x in ms)} "
              f"({n_ops / min(ms) / 1e9:.1f} TFLOP/s on 5 products); "
              f"{prof}{lib}", flush=True)
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()
    print(f"{label}: {len(bad)} checks failed", flush=True)


def main():
    if sys.argv[1:2] == ["--tree"]:
        run_tree(sys.argv[2], sys.argv[3], sys.argv[4] == "1")
        return
    names = list(VARIANTS)
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"])
    t0 = time.time()
    trees = {n: make(n, VARIANTS[n]) for n in names}
    procs = [build(t) for t in trees.values()]
    for p in procs:
        p.wait()
    print(f"built in {time.time() - t0:.1f} s", flush=True)
    for n, tree in trees.items():
        try:
            report(n, tree)
        except Exception as e:
            print(n, "report failed", e, flush=True)
    for i, n in enumerate(names + names[::-1]):
        subprocess.run([sys.executable, __file__, "--tree", str(trees[n]), n,
                        "1" if i == 0 else "0"])


if __name__ == "__main__":
    main()
