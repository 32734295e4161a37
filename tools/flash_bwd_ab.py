"""K5 bwd before and after a change, on the card: each tree's backward
kernel built and timed in a process of its own, in the order old, new,
new, old, beside the backward of ``scaled_dot_product_attention``; then
the SASS of the kernels the change must leave alone compared.

    python tools/flash_bwd_ab.py OLD_TREE NEW_TREE

A tree is a checkout of the repo (``git archive`` of a commit unpacked
into a git-ignored directory such as ``build/``).  Times are ms a call
(CUDA events, 10 calls after a warm-up, three such runs) of
``flash_attention_bwd_cuda`` on the output and logsumexp of the tree's
own forward (and each kernel's device ms in one profiled call).
bfloat16: llama3.2-3b's training layer (3 and 1 x 4,096 tokens, 24/8
heads of 128, causal), head dim 64 (3 x 4,096, 24/8) and gemma3-27b's
local layer (1 x 4,096, 32/16 heads of 128, window 1,024).  float32:
``chip_smoke.py`` [23a]'s shape (1 x 2,048, 24/8 heads of 128) causal and
with a window of 1,024, head dim 64 (1 x 4,096, 24/8) and [23a]'s head
dim 16 case (2 x 512, 4/2).  Each with its bound (``chip_smoke.py``'s
``bwd_cost``; float32 as three TF32 products).  Beside them, in the same
process: SDPA's backward as ``chip_smoke.py`` [23a] times it
(``sdpa_bwd_ms``: the KV heads repeated, the (B, S, H, dh) tensors
transposed; the flash backend
in bfloat16, the memory-efficient one in float32 or with the band of a
window as a boolean mask), and for the causal bfloat16 shapes once more
with the backend PyTorch picks itself, on copies contiguous in (B, H, S,
dh) (the backend named from a profile of one call).  The SASS compared
(after normalising constant-bank offsets, branch targets and the
anonymous namespace's per-file name) must match for every kernel the
float32 route's redesign leaves alone: the bfloat16 backward kernels and
the row pass (``flashattn_bwd``) and every forward kernel
(``flashattn``); the kernels of either build that the other lacks (the
float32 backward's, renamed) are listed as moved.
"""
import collections
import difflib
import glob
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
# type -> (B, S, H, KV, dh, window) ...
SHAPES = {"bfloat16": ((3, 4096, 24, 8, 128, None),
                       (1, 4096, 24, 8, 128, None),
                       (3, 4096, 24, 8, 64, None),
                       (1, 4096, 32, 16, 128, 1024)),
          "float32": ((1, 2048, 24, 8, 128, None),
                      (1, 2048, 24, 8, 128, 1024),
                      (1, 4096, 24, 8, 64, None),
                      (2, 512, 4, 2, 16, None))}


def time_tree(tree: str, label: str) -> None:
    """Build ``tree``'s K5 and K5 bwd and print their backward times
    (run in a child)."""
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    sys.path.append(str(REPO))
    import torch
    from repro_torch.kernels.flashattn import kernel as fk
    from chip_smoke import (BF16_OPS_PER_S, FLASH_F32_PRODUCTS,
                            TF32_OPS_PER_S, bound, bwd_cost, cuda_time_ms,
                            sdpa_bwd_ms)
    fk.library()
    fk.bwd_library()
    out = []
    for name, shapes in SHAPES.items():
        dtype = getattr(torch, name)
        for b, s, h, kv, dh, window in shapes:
            g = torch.Generator(device="cuda").manual_seed(0)
            q, k, v, do = (torch.randn(b, s, n, dh, generator=g,
                                       device="cuda").to(dtype)
                           for n in (h, kv, kv, h))
            o, lse = fk.flash_attention_cuda(q, k, v, window=window,
                                             return_lse=True)
            row = [cuda_time_ms(lambda: fk.flash_attention_bwd_cuda(
                q, k, v, o, lse, do, window=window), 10) for _ in range(3)]
            sdpa = sdpa_bwd_ms(q, k, v, do, True, window, 10)
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                fk.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                            window=window)
                torch.cuda.synchronize()
            kernel = re.compile(r"bwd_\w+")
            kernels = ", ".join(
                f"{kernel.search(e.key).group(0)} "
                f"{e.device_time_total / 1e3:.3f}"
                for e in prof.key_averages() if "bwd_" in e.key)
            n_bytes, n_ops = bwd_cost((b, s, h, kv, dh), True,
                                      q.element_size(), window)
            b_ms, b_by = bound(n_bytes, n_ops, BF16_OPS_PER_S) \
                if dtype == torch.bfloat16 else bound(
                    n_bytes, FLASH_F32_PRODUCTS * n_ops, TF32_OPS_PER_S)
            text = (f"{name} {(b, s, h, kv, dh)} window {window}: "
                    + ", ".join(f"{x:.3f}" for x in row)
                    + f" ({n_ops / min(row) / 1e9:.1f} TFLOP/s on the five "
                    f"products; bound {b_ms:.3f} by {b_by}; {kernels}) | "
                    f"SDPA {sdpa:.3f}")
            if window is None and dtype == torch.bfloat16:
                text += f", {default_backend_ms(q, k, v, do, h // kv)}"
            out.append(text)
            del q, k, v, do, o, lse
            torch.cuda.empty_cache()
    print(label, tree, "|", " || ".join(out), flush=True)


def default_backend_ms(q, k, v, do, rep: int) -> str:
    """SDPA's causal backward with the backend PyTorch picks, on (B, H,
    S, dh)-contiguous copies with the KV heads repeated."""
    import torch
    from chip_smoke import cuda_time_ms
    qt, kt, vt = (x.transpose(1, 2).repeat_interleave(r, dim=1)
                  .contiguous().requires_grad_(True)
                  for x, r in ((q, 1), (k, rep), (v, rep)))
    dot = do.transpose(1, 2).contiguous()
    ot = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True)

    def grad():
        return torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)

    bhsd = cuda_time_ms(grad, 10)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        grad()
        torch.cuda.synchronize()
    names = " ".join(e.key.lower() for e in prof.key_averages())
    chosen = next((tag for tag, keys in (
        ("cuDNN", ("cudnn",)), ("flash", ("flash",)),
        ("memory-efficient", ("fmha", "efficient")))
        if any(k in names for k in keys)), "unknown")
    return (f"PyTorch's default backend ({chosen}) on (B, H, S, "
            f"dh)-contiguous copies {bhsd:.3f}")


def sass(tree: str, lib: str) -> dict:
    """kernel -> its normalised SASS lines, from ``tree``'s build of
    ``lib``."""
    sys.path.insert(0, str(REPO))
    from chip_smoke import cuobjdump_path
    path = glob.glob(str(Path(tree) / "build" / "kernels" / f"{lib}-*.so"))
    text = subprocess.run([cuobjdump_path(), "-sass", path[0]],
                          capture_output=True, text=True, check=True).stdout
    insn = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")
    out, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = re.sub(r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}",
                          "", line.split("Function :")[1].strip())
            out[name] = []
        elif name is not None:
            m = insn.search(line)
            if m:
                x = re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[]", m.group(1))
                out[name].append(re.sub(r"BRA 0x[0-9a-f]+", "BRA", x))
    return out


def compare(old: str, new: str) -> None:
    """The SASS of each kernel the change must not move, old against new;
    then the kernels only one build has."""
    for lib, kinds in (("flashattn_bwd", ("bwd_dkdv_wgmma_kernel",
                                          "bwd_dq_wgmma_kernel",
                                          "bwd_delta_kernel")),
                       ("flashattn", ("flash_bf16_kernel",
                                      "flash_f32_kernel"))):
        a, b = sass(old, lib), sass(new, lib)
        names = sorted(k for k in a if any(x in k for x in kinds))
        same = 0
        for name in names:
            fa, fb = a[name], b.get(name)
            if fb is None:
                print(f"{lib} {name}: missing in the new build", flush=True)
                continue
            if fa == fb:
                same += 1
                continue
            diff = [x for x in difflib.unified_diff(fa, fb, lineterm="", n=0)
                    if x[:1] in "+-" and x[:3] not in ("+++", "---")]
            ha = collections.Counter(x.split()[0] for x in fa)
            hb = collections.Counter(x.split()[0] for x in fb)
            moved = {k: hb[k] - ha[k] for k in set(ha) | set(hb)
                     if ha[k] != hb[k]}
            print(f"{lib} {name}: {len(fa)} instructions old, {len(fb)} new;"
                  f" {len(diff)} lines differ; opcode counts moved {moved}",
                  flush=True)
        print(f"{lib}: {same} of {len(names)} kernels "
              f"({', '.join(kinds)}) identical to the old build", flush=True)
        for mine, other, tag in ((a, b, "old"), (b, a, "new")):
            only = sorted(k for k in mine if k not in other)
            if only:
                print(f"{lib}: moved, only in the {tag} build "
                      f"({len(only)}): {', '.join(only)}", flush=True)


def main() -> None:
    if len(sys.argv) == 4 and sys.argv[1] == "--time":
        time_tree(sys.argv[2], sys.argv[3])
        return
    old, new = sys.argv[1:3]
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"], check=True)
    for tree, label in ((old, "old1"), (new, "new1"), (new, "new2"),
                        (old, "old2")):
        subprocess.run([sys.executable, __file__, "--time", tree, label],
                       check=True)
    compare(old, new)


if __name__ == "__main__":
    main()
