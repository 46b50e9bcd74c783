"""Run phase 10 of chip_smoke.py alone on the card: build the kernels,
write phase 6's PNG tree (without phase 6's runs), and run
``chip_smoke.phase_parallel`` (two ranks over gloo sharing the card; it
prints which collectives gloo runs on CUDA tensors, checked by value).
With ``--lm``, run phase 11 alone instead (``chip_smoke.phase_lm_parallel``:
the LM's tensor-parallel and pipeline paths, two ranks over gloo); with
``--moe``, phase 12 (the MoE LM on one card and in two expert-parallel
ranks over gloo, SegFormer-b3, the int8 check).

    python3 scripts/probe_parallel.py [--lm | --moe]
"""
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("probe_parallel: no CUDA card")
    from vivim_tpu_torch import native
    from vivim_tpu_torch.kernels import _build

    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    print(f"build {_build.build_all():.1f} s", flush=True)
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    if "--lm" in sys.argv[1:]:
        t0 = time.perf_counter()
        launched, perf = cs.phase_lm_parallel(
            cs.card_peaks(torch.cuda.get_device_name(0)))
        print(f"phase 11: {time.perf_counter() - t0:.1f} s; {launched}",
              flush=True)
        print(json.dumps(perf), flush=True)
        sys.exit(0)
    if "--moe" in sys.argv[1:]:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        for name, phase in (("12a", cs.phase_moe_lm),
                            ("12b", cs.phase_moe_ep),
                            ("12c", cs.phase_segformer),
                            ("12d", cs.phase_int8_eval)):
            t0 = time.perf_counter()
            phase()
            torch.cuda.empty_cache()
            print(f"phase {name}: {time.perf_counter() - t0:.1f} s",
                  flush=True)
        sys.exit(0)
    if native.get_lib() is None:
        sys.exit("probe_parallel: the native host ops did not build")
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        raw, folds = os.path.join(work, "raw"), os.path.join(work, "folds")
        cs.write_png_tree(raw, size=cs.CLI_SOURCE)
        cs.write_fold_tree(raw, folds)
        print(f"tree {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        launched, perf = cs.phase_parallel(work)
        print(f"phase 10: {time.perf_counter() - t0:.1f} s; {launched}",
              flush=True)
        print(json.dumps(perf), flush=True)
