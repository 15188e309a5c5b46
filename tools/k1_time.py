#!/usr/bin/env python3
"""Check and time K1 (flash_attention_cuda) of the port in one or more
source trees, on one CUDA card.

    python3 tools/k1_time.py [--all | --alpha] [TREE ...]

Each tree (default: this checkout) runs in a process of its own, which
builds that tree's kernels, prints ptxas's report and the SASS counts of
each kernel of K1's library (HGMMA, those on TF32 operands, FFMA) and the
rescale check of chip_smoke.py's phase 2 (the signed mean error against
f64 at N = 10765 of the tree's bf16 kernel, its plain version and the
online softmax restated with each alpha form; with --alpha nothing more),
and then runs that tree's flash_attention_cuda on the f32 cases of
chip_smoke.py's phase 2 (with --all, every case), on phase 2's inputs.  Per case it prints
the max abs error against the tree's plain version (f32 cases: the
kernel's and the plain version's against softmax in f64), the time per
call as a caller sees it (CUDA events over calls issued back to back), the
device
time per call of each kernel the call launches (torch.profiler), SDPA's
efficient and cuDNN backends on the same tensors (device ms, or
"refused"), and the bounds of chip_smoke.k1_bound.  To compare two
commits, unpack both and give them as parent, change, change, parent.  The
card's name and power limit come first.
"""
from __future__ import annotations

import importlib.util
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS = 10


def smoke():
    """This checkout's chip_smoke.py (its phase-2 cases and helpers),
    whatever tree is timed."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_device_ms(fn, iters: int):
    """{kernel name: device ms per call of fn} from torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = e.self_cuda_time_total
            m = re.search(r"(flash_fwd_\w+?|split_kv_f32)\b", e.key)
            name = m.group(1) if m else e.key[:40]
            out[name] = round(out.get(name, 0.0) + t / 1e3 / iters, 4)
    return out


def f64_attention(q, k, v, bias):
    """softmax(q.k^T / 8 + bias).v with every step in f64."""
    import torch
    s = torch.matmul(q.double(), k.double().transpose(-1, -2)) * 0.125
    if bias is not None:
        s = s + bias.double()
    return torch.matmul(torch.softmax(s, -1), v.double())


def child(tree: str, mode: str) -> None:
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from depthmap_tpu_torch.ops import cuda_build
    from depthmap_tpu_torch.ops import flash_attention as fa
    if not fa.__file__.startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {fa.__file__}, not {tree}'s package")
    sm = smoke()
    lib = fa._lib()
    for line in cuda_build.build_logs.get("flash_attention", "").splitlines():
        if "entry function" in line or "registers" in line or \
                "spill" in line:
            print(f"[k1-ptxas] {tree} {line.strip()}", flush=True)
    cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc_path()),
                             "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib._name],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    print("[k1-sass] " + json.dumps({"tree": tree,
                                     **sm.k1_sass_counts(sass)}),
          flush=True)
    print("[k1-alpha] " + json.dumps({"tree": tree,
                                      **sm.k1_alpha_drift(fa)}), flush=True)
    if mode == "alpha":
        return
    g = torch.Generator(device="cpu").manual_seed(1)
    for name, dts, b, h, n, bb, *rest in sm.K1_CASES:
        if mode != "all" and dts != "float32":
            continue
        nk = rest[0] if rest else n
        dt = getattr(torch, dts)

        def mk(*shape, scale=1.0):
            return (torch.randn(*shape, generator=g) * scale).to("cuda", dt)
        q = mk(b, h, n, 64, scale=sm.K1_Q_SCALE)
        k, v = mk(b, h, nk, 64), mk(b, h, nk, 64, scale=sm.K1_V_SCALE)
        bias = fa.pad_bias_rows(mk(bb, h, n, nk)) if bb else None
        got = fa.flash_attention_cuda(q, k, v, bias)
        want = fa.flash_attention_plain(q, k, v, bias)
        err = (got.float() - want.float()).abs().max().item()
        f64 = {}
        if dt == torch.float32:   # both against softmax in f64
            ref = f64_attention(q, k, v, bias)
            f64 = {"max_abs_err_vs_f64": (got.double() - ref).abs().max()
                   .item(), "plain_max_abs_err_vs_f64":
                   (want.double() - ref).abs().max().item()}
            del ref
        del got, want

        def k1():
            return fa.flash_attention_cuda(q, k, v, bias)
        ms = sm.cuda_ms(k1, ITERS)
        dev = kernel_device_ms(k1, ITERS)
        sdpa = {lib_: (t if t == "refused" or t[1] is None
                       else round(t[1], 4))
                for lib_, t in sm.sdpa_times(q, k, v, bias).items()
                if lib_ != "flash"}
        (bound_ms, basis), split = sm.k1_bound(b, h, n, nk, bb, dts)
        total = sum(dev.values())
        print("[k1-time] " + json.dumps({
            "tree": tree, "case": name, "max_abs_err": err, **f64,
            "ms_per_call": round(ms, 4), "device_ms": round(total, 4),
            "device_ms_by_kernel": dev, "sdpa_device_ms": sdpa,
            "bound_us": round(bound_ms * 1e3, 1), "bound_by": basis,
            "device_share_of_bound": round(bound_ms / total, 3),
            **({} if split is None else {
                "split_tf32_bound_us": round(split[0] * 1e3, 1),
                "split_tf32_bound_by": split[1],
                "device_share_of_split_tf32_bound":
                    round(split[0] / total, 3)})}), flush=True)
        del q, k, v, bias
        torch.cuda.empty_cache()


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        child(sys.argv[2], sys.argv[3])
        return 0
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    args = sys.argv[1:]
    mode = "all" if "--all" in args else \
        "alpha" if "--alpha" in args else "f32"
    trees = [a for a in args if a not in ("--all", "--alpha")] or [ROOT]
    for tree in trees:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                        tree, mode], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
