"""Old against new for the redesigned kernels, in one run on one card.

    python -m det3d_tpu_torch.experiments.kernel_redesigns

from the repository root, on a machine with one CUDA card and `nvcc`. It
measures what `chip_smoke.py` does not carry: kernels that the package no
longer launches.

  * NMS: the one-block-per-class kernel (`experiments/nms_one_block.cu`) at
    the main path's shape (a real frame's 3 x 1000 candidates, 20 % invalid),
    its time and how it splits between building the suppression matrix and
    sweeping it (clock64 stamps of thread 0, worst class; and the kernel with
    the sweep cut out), beside `kernels/csrc/nms.cu` on the same inputs, in
    turns (old, new, new, old), on a chain of 1000 dependent decisions and on
    random boxes; the new mask kernel and sweep apart, both with the sweep
    launched early or only after the mask kernel, and both in one launch
    (`experiments/nms_one_launch.cu`: the last tile block of a class sweeps);
    the sweep's register chain alone (`experiments/chain_probe.cu`) beside
    the whole sweep's cycles per chunk.
  * Fence: the `cls_preds` view (2 x 9 x 400 x 400 bf16 out of a
    channels-last head output) through the generic element-per-thread kernel,
    which copied it before, beside the transpose kernel that copies it now,
    in turns, warm and after an L2 flush, the library's contiguous clone, and
    the transpose kernel at other tile sizes than `copy_plan` picks.

  * The blocked backward (`gather_rows_blocked`, csrc/scatter.cu): the
    kernel it replaced (`experiments/blocked_bwd_per_piece.cu`, a thread
    per 16-byte piece) beside it, in turns, at the 20 cm train shape
    (batch 2, 12 000 of 16 000 pillars a sample) and at the 10 cm one
    (`ntusl_10cm.json`'s blocked train layout, 15 000 of 20 000), in f32
    and bf16, warm and after an L2 flush, beside a one-element fill (the
    least any launch costs); and csrc/scatter.cu built with
    `BLOCKED_BWD_PDL=0`, which launches it in stream order in place of as a
    programmatic dependent of the kernel before it.

Every time is a device time from CUDA events (`chip_smoke.cuda_ms`,
`chip_smoke.single_call_ms`); the card's name and power limit are printed
first.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from det3d_tpu_torch.kernels import build, fence_cuda, nms_cuda
from det3d_tpu_torch.kernels import matcher_cuda as mc

HERE = Path(__file__).parent


def start_build(source: Path, tag: str, defines=(),
                flags=build.EXTRA_FLAGS["nms"]) -> tuple[Path, subprocess.Popen]:
    """Start `nvcc` on `source` with the NMS and matcher libraries' flags
    (exact float32: no contraction, IEEE division) or `flags` into
    `_build/lib<tag>.so`."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = build.BUILD_DIR / f"lib{tag}.so"
    cmd = [build.nvcc_path(), *build._COMMON_FLAGS, *flags, *(f"-D{d}" for d in defines),
           "-o", str(out), str(source)]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish_build(out: Path, proc: subprocess.Popen) -> ctypes.CDLL:
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {out.name}:\n{log}")
    return ctypes.CDLL(str(out))


def build_experiment(name: str, function: str, argtypes: list) -> ctypes.CDLL:
    """Build `experiments/<name>.cu` and bind `function`."""
    lib = finish_build(*start_build(HERE / f"{name}.cu", name))
    getattr(lib, function).argtypes = argtypes
    getattr(lib, function).restype = ctypes.c_int
    return lib


def nms_old_and_new(thr: float, cases) -> None:
    ptr = ctypes.c_void_p
    lib = build_experiment("nms_one_block", "det3d_nms_one_block",
                           [ptr] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float, ptr, ctypes.c_int, ptr])
    fused = build_experiment("nms_one_launch", "det3d_nms_one_launch",
                             [ptr] * 5 + [ctypes.c_int] * 2 + [ctypes.c_float, ptr])

    def one_launch(boxes, valid, mask, done):
        keep = torch.empty(valid.shape, dtype=torch.bool, device="cuda")
        err = fused.det3d_nms_one_launch(boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), mask.data_ptr(),
                                         done.data_ptr(), boxes.shape[0], boxes.shape[1], thr,
                                         torch.cuda.current_stream().cuda_stream)
        cs.check(err == 0, f"nms_one_launch.cu failed with CUDA error {err}")
        return keep

    def one_block(boxes, valid, stamps, phases=3):
        keep = torch.empty(valid.shape, dtype=torch.bool, device="cuda")
        err = lib.det3d_nms_one_block(boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), boxes.shape[0],
                                      boxes.shape[1], thr, stamps.data_ptr(), phases,
                                      torch.cuda.current_stream().cuda_stream)
        cs.check(err == 0, f"nms_one_block.cu failed with CUDA error {err}")
        return keep

    for name, boxes, valid in cases:
        stamps = torch.zeros((boxes.shape[0], 4), dtype=torch.int64, device="cuda")
        want = nms_cuda.nms_keep_plain(boxes, valid, thr)
        cs.check(torch.equal(one_block(boxes, valid, stamps), want), f"one-block kernel differs on '{name}'")
        cs.check(torch.equal(nms_cuda.nms_keep_cuda(boxes, valid, thr), want), f"mask + sweep differs on '{name}'")
        old = lambda: one_block(boxes, valid, stamps)
        new = lambda: nms_cuda.nms_keep_cuda(boxes, valid, thr)
        times = [cs.cuda_ms(fn) for fn in (old, new, new, old)]
        print(f"nms '{name}' {tuple(valid.shape)}: one block per class {times[0]:.4f} / {times[3]:.4f} ms, "
              f"mask + sweep {times[1]:.4f} / {times[2]:.4f} ms")
        mask = nms_cuda.mask_scratch(boxes)
        parts = {"mask kernel alone": 1, "sweep alone": 2, "both, sweep after the mask kernel": 3,
                 "both, sweep launched early": 7}
        for order in (parts, dict(reversed(parts.items()))):
            print("  mask + sweep: " + ", ".join(
                f"{label} {cs.cuda_ms(lambda: nms_cuda.launch(boxes, valid, thr, mask, parts=bits)):.4f} ms"
                for label, bits in order.items()))
        cs.check(torch.equal(nms_cuda.launch(boxes, valid, thr, mask, parts=7), want), "early launch differs")
        done = torch.zeros(boxes.shape[0], dtype=torch.int32, device="cuda")
        for _ in range(2):  # the second call finds the counters the first one set back
            cs.check(torch.equal(one_launch(boxes, valid, mask, done), want), f"one launch differs on '{name}'")
        two = lambda: nms_cuda.launch(boxes, valid, thr, mask)
        one = lambda: one_launch(boxes, valid, mask, done)
        t = [cs.cuda_ms(fn) for fn in (one, two, two, one)]
        print(f"  one launch, the last tile block sweeps: {t[0]:.4f} / {t[3]:.4f} ms; two launches, the sweep "
              f"launched early: {t[1]:.4f} / {t[2]:.4f} ms")
        one_block(boxes, valid, stamps)
        torch.cuda.synchronize()
        t = stamps.cpu()
        cycles = (t[:, 1:] - t[:, :-1]).tolist()
        for ci, (build_c, sweep_c, write_c) in enumerate(cycles):
            total = build_c + sweep_c + write_c
            print(f"  class {ci}: {total} cycles after the box loads' start: matrix {build_c} "
                  f"({100 * build_c / total:.1f} %), sweep {sweep_c} ({100 * sweep_c / total:.1f} %), "
                  f"keep bytes {write_c} ({100 * write_c / total:.1f} %)")
        worst = max(range(len(cycles)), key=lambda ci: sum(cycles[ci]))
        share = [c / sum(cycles[worst]) for c in cycles[worst]]
        whole = (times[0] + times[3]) / 2
        print(f"  the slowest class bounds the launch: of {whole:.4f} ms, matrix {share[0] * whole:.4f} ms, "
              f"sweep {share[1] * whole:.4f} ms")
        matrix_only = cs.cuda_ms(lambda: one_block(boxes, valid, stamps, phases=1))
        print(f"  the same kernel with the sweep cut out: {matrix_only:.4f} ms")


def chain_alone() -> None:
    """Cycles per row of the sweep's register chain with nothing around it."""
    ptr = ctypes.c_void_p
    lib = build_experiment("chain_probe", "det3d_chain_alone", [ptr] * 3 + [ctypes.c_int, ptr])
    words = torch.randint(0, 2**31 - 1, (32, 32), dtype=torch.int32, device="cuda")
    out = torch.zeros(32, dtype=torch.int32, device="cuda")
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    reps = 100
    for _ in range(2):
        err = lib.det3d_chain_alone(words.data_ptr(), out.data_ptr(), cycles.data_ptr(), reps,
                                    torch.cuda.current_stream().cuda_stream)
        cs.check(err == 0, f"chain_probe.cu failed with CUDA error {err}")
        torch.cuda.synchronize()
    per_row = cycles.item() / (reps * 32)
    print(f"nms sweep, the chain alone (one warp, {reps} x 32 rows in registers): {per_row:.2f} cycles a row, "
          f"{32 * per_row:.0f} a chunk of 32 rows")


def sweep_cycles(thr: float, boxes, valid) -> None:
    """SM cycles of the whole sweep per chunk, from its time alone at two sizes
    (the difference leaves the launch and the set-up out) and the SM clock."""
    clock_mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                                     capture_output=True, text=True, check=True).stdout.split()[0])
    times = {}
    for k in (512, 1024):
        b, v = boxes[:, :k].contiguous(), valid[:, :k].contiguous()
        mask = nms_cuda.mask_scratch(b)
        nms_cuda.launch(b, v, thr, mask, parts=1)
        times[k] = cs.cuda_ms(lambda: nms_cuda.launch(b, v, thr, mask, parts=2))
    per_chunk_ms = (times[1024] - times[512]) / 16
    print(f"nms sweep alone: {times[512]:.4f} ms at K = 512, {times[1024]:.4f} ms at K = 1024: "
          f"{per_chunk_ms * 1e3:.3f} us a chunk of 32 rows, ~{per_chunk_ms * 1e-3 * clock_mhz * 1e6:.0f} cycles at the "
          f"card's maximum SM clock of {clock_mhz:.0f} MHz")


def fence_old_and_new() -> None:
    head = torch.randn(2, 90, 400, 400, device="cuda").to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    x = head[:, :9].reshape(2, 9, 1, 400, 400).transpose(1, 2)
    plan = fence_cuda.copy_plan(x)
    cs.check(plan.route == "transpose", f"cls_preds takes the {plan.route} kernel")
    arrays = [(ctypes.c_int64 * fence_cuda.MAX_RANK)(*v) for v in (plan.sizes, plan.src, plan.dst)]

    def copy_by(route: str, forced: fence_cuda.CopyPlan):
        """`x` through the named kernel of csrc/fence.cu, whatever `copy_plan` says."""
        out = torch.empty(x.shape, dtype=x.dtype, device="cuda")
        err = fence_cuda._lib().det3d_fence_copy(
            x.data_ptr(), out.data_ptr(), x.numel(), x.element_size(), fence_cuda.ROUTES.index(route),
            len(plan.sizes), *(ctypes.addressof(a) for a in arrays), forced.inner, forced.tile, forced.row,
            torch.cuda.current_stream().cuda_stream)
        cs.check(err == 0, f"fence.cu failed with CUDA error {err}")
        return out

    generic = lambda: copy_by("generic", plan._replace(inner=0, tile=0, row=0))
    new = lambda: fence_cuda.fence_copy_cuda(x)
    library = lambda: x.clone(memory_format=torch.contiguous_format)
    want = library()
    cs.check(torch.equal(cs.bits(generic()), cs.bits(want)), "generic kernel differs")
    cs.check(torch.equal(cs.bits(new()), cs.bits(want)), "transpose kernel differs")
    times = [cs.cuda_ms(fn) for fn in (generic, new, new, generic)]
    print(f"fence cls_preds {tuple(x.shape)}, 30 calls, warm L2: generic {times[0]:.4f} / {times[3]:.4f} ms, "
          f"transpose {times[1]:.4f} / {times[2]:.4f} ms, library {cs.cuda_ms(library):.4f} ms, "
          f"clone keeping order {cs.cuda_ms(lambda: x.clone()):.4f} ms")
    flush = torch.empty(cs.L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for label, fl in (("warm L2", None), ("after an L2 flush", flush)):
        t = [cs.single_call_ms(fn, fl) for fn in (generic, new, library, new, generic)]
        print(f"fence cls_preds, single calls, {label}: generic {t[0]:.4f} / {t[4]:.4f} ms, "
              f"transpose {t[1]:.4f} / {t[3]:.4f} ms, library {t[2]:.4f} ms")
    for tile in (64, 128, 256, 512):
        piece = fence_cuda.VEC_BYTES // x.element_size()
        forced = plan._replace(tile=tile, row=tile + (piece if tile // piece % 2 == 0 else 0))
        tiled = lambda: copy_by("transpose", forced)
        cs.check(torch.equal(cs.bits(tiled()), cs.bits(want)), f"transpose kernel differs at tile {tile}")
        print(f"fence cls_preds, transpose with tiles of {tile} pixels: {cs.cuda_ms(tiled):.4f} ms warm, "
              f"{cs.single_call_ms(tiled, flush):.4f} ms after an L2 flush")


def blocked_old_and_new() -> None:
    """The blocked backward before and after its redesign, and launched in
    stream order, at the 20 cm and 10 cm train shapes."""
    from det3d_tpu_torch.config import load_config
    from det3d_tpu_torch.kernels import scatter_cuda as sc
    from det3d_tpu_torch.models.pointpillars import block0_blocking

    stream_order = bind_scatter(finish_build(*start_build(build.CSRC / "scatter.cu", "scatter_stream_order",
                                                          ("BLOCKED_BWD_PDL=0",), flags=())))
    flush = torch.empty(cs.L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    one = torch.empty(1, device="cuda")
    print(f"blocked bwd: a one-element fill, the least a launch costs in this timing: {cs.cuda_ms(one.zero_):.4f} ms "
          f"warm, {cs.single_call_ms(one.zero_, flush):.4f} ms as a single call")
    gen = torch.Generator().manual_seed(cs.SEED + 5)
    for path, kept in (("configs/ntusl_20cm.json", 12_000), ("configs/ntusl_10cm.json", 15_000)):
        cfg = load_config(path)
        grid = tuple(cfg.grid_size[:2])
        nblk, halo = block0_blocking(grid)
        _, rtot = sc.blocked_rows(grid, nblk, halo)
        for dtype in (torch.float32, torch.bfloat16):
            label = f"{path.split('/')[-1]} {str(dtype)}"
            t = cs.time_blocked_bwd(label, grid, cfg.max_voxels, 64, nblk, halo, kept, dtype, gen)
            _, coors = cs.layout_inputs(cs.TRAIN_BATCH, cfg.max_voxels, 64, grid, kept, dtype, gen)
            g = cs.blocked_grad(cs.TRAIN_BATCH, 64, nblk, rtot, grid[1] // 2, dtype, gen)
            old = lambda: cs.blocked_bwd_per_piece(g, coors, halo)
            new = lambda: sc.scatter_to_bev_s2d_blocked_bwd_cuda(g, coors, halo)
            single = [cs.single_call_ms(fn, flush) for fn in (old, new, new, old)]
            print(f"  single calls after an L2 flush: old {single[0]:.4f} / {single[3]:.4f} ms, "
                  f"new {single[1]:.4f} / {single[2]:.4f} ms (bound {t['bound_ms']:.5f})")
            want = new()
            shipped = sc._lib
            sc._lib = lambda: stream_order
            try:
                cs.check(torch.equal(cs.bits(new()), cs.bits(want)), "the stream-order launch differs")
                variant = cs.cuda_ms(new)
            finally:
                sc._lib = shipped
            print(f"  launched in stream order (no programmatic dependent launch): {variant:.4f} ms "
                  f"(as shipped, right after: {cs.cuda_ms(new):.4f})")


def bind_scatter(lib: ctypes.CDLL) -> ctypes.CDLL:
    """A variant of csrc/scatter.cu bound as `scatter_cuda._lib` binds it."""
    fn = lib.det3d_scatter_to_bev_s2d_blocked_bwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_int64] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


# variants of csrc/matcher.cu by its compile-time switches: blocks per sample
# of each pass, and pass 2's stores with or without the streaming hint
MATCHER_VARIANTS = {
    "pass 1 with 132 blocks a sample": ("MATCHER_BLOCKS_P1=132",),
    "pass 1 with 528 blocks a sample": ("MATCHER_BLOCKS_P1=528",),
    "pass 2 with 264 blocks a sample": ("MATCHER_BLOCKS_P2=264",),
    "pass 2 with 528 blocks a sample": ("MATCHER_BLOCKS_P2=528",),
    "pass 2 with a block for every 8 chunks": ("MATCHER_BLOCKS_P2=1000000",),
    "pass 2 with plain stores": ("MATCHER_STREAMING_STORES=0",),
}


def matcher_old_and_new(cfg) -> None:
    """The matcher kernels that visited every gt of the class for every anchor
    (`experiments/matcher_per_gt.cu`) beside `kernels/csrc/matcher.cu` on the
    full-width train batch, in turns; the new passes' parts and variants; what
    the cull leaves of the input."""
    from det3d_tpu_torch.train.trainer import Trainer, host_batch

    ptr, i = ctypes.c_void_p, ctypes.c_int
    jobs = {"old": start_build(HERE / "matcher_per_gt.cu", "matcher_per_gt")}
    for n, (label, defines) in enumerate(MATCHER_VARIANTS.items()):
        jobs[label] = start_build(build.CSRC / "matcher.cu", f"matcher_variant{n}", defines)
    libs = {label: finish_build(*job) for label, job in jobs.items()}
    old = libs.pop("old")
    old.det3d_matcher_per_gt_max.argtypes = [ptr] * 6 + [i] * 4 + [ptr, ptr]
    old.det3d_matcher_per_gt_assign.argtypes = [ptr] * 10 + [i] * 4 + [ptr] * 5
    old.det3d_matcher_per_gt_max.restype = old.det3d_matcher_per_gt_assign.restype = i

    trainer = Trainer(cfg)
    trainer.init_state(cs.SEED)
    batch = trainer.to_device(host_batch(cfg, cs.train_scenes(cfg, cs.SEED)))
    args = cs.matcher_inputs(trainer, batch, "real frames")
    tables = trainer.assigner.tables
    mask, gt_boxes, gt_bv, gt_classes, gt_valid = args
    (b, a), g, ncls = mask.shape, gt_valid.shape[1], tables.class_start.shape[0] - 1
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def old_gt_max():
        bits = torch.empty((b, g), dtype=torch.int32, device="cuda")
        err = old.det3d_matcher_per_gt_max(tables.anchors_bv.data_ptr(), mask.data_ptr(), gt_bv.data_ptr(),
                                           gt_classes.data_ptr(), gt_valid.data_ptr(), tables.class_start.data_ptr(),
                                           ncls, b, a, g, bits.data_ptr(), stream())
        cs.check(err == 0, f"matcher_per_gt.cu gt-max failed with CUDA error {err}")
        return bits

    def old_assign(bits):
        out = (torch.empty((b, a), dtype=torch.int32, device="cuda"), torch.empty((b, 7, a), device="cuda"),
               torch.empty((b, a), device="cuda"), torch.empty((b, a), dtype=torch.int32, device="cuda"))
        err = old.det3d_matcher_per_gt_assign(
            tables.anchors.data_ptr(), tables.anchors_bv.data_ptr(), mask.data_ptr(), gt_boxes.data_ptr(),
            gt_bv.data_ptr(), gt_classes.data_ptr(), gt_valid.data_ptr(), bits.data_ptr(),
            tables.class_start.data_ptr(), tables.thresholds.data_ptr(), ncls, b, a, g,
            *(t.data_ptr() for t in out), stream())
        cs.check(err == 0, f"matcher_per_gt.cu assign failed with CUDA error {err}")
        return out

    new_gt_max = lambda: mc.gt_max_bits_cuda(tables, *args)
    new_assign = lambda bits, early=False: mc.assign_cuda(tables, *args, bits, early=early)
    bits = new_gt_max()
    cs.check(torch.equal(old_gt_max(), bits), "old and new gt-max differ")
    for name, x, y in zip(("labels", "targets", "weights", "dirs"), old_assign(bits), new_assign(bits)):
        cs.check(torch.equal(x, y), f"old and new {name} differ")  # one logf: the targets are equal too
    print(f"matcher on the train batch ({b} x {a} anchors, G = {g}): old and new results equal; "
          f"cull: {cs.matcher_cull_stats(tables, *args[:1], *args[2:])}")

    def in_turns(label, old_fn, new_fn):
        t = [cs.cuda_ms(fn) for fn in (old_fn, new_fn, new_fn, old_fn)]
        print(f"  {label}: every gt per anchor {t[0]:.4f} / {t[3]:.4f} ms, culled {t[1]:.4f} / {t[2]:.4f} ms")

    in_turns("pass 1 (memset + kernel)", old_gt_max, new_gt_max)
    in_turns("pass 2", lambda: old_assign(bits), lambda: new_assign(bits))
    in_turns("both passes, one call", lambda: old_assign(old_gt_max()), lambda: mc.match_cuda(tables, *args))
    parts = {"memset alone": 1, "kernel alone": 2, "memset + kernel": 3}
    for order in (parts, dict(reversed(parts.items()))):
        print("  pass 1: " + ", ".join(
            f"{label} {cs.cuda_ms(lambda: mc.gt_max_bits_cuda(tables, *args, parts=p)):.4f} ms"
            for label, p in order.items()))
    both = lambda early: (lambda: new_assign(new_gt_max(), early))
    t = [cs.cuda_ms(fn) for fn in (both(False), both(True), both(True), both(False))]
    print(f"  both passes, pass 2 launched after pass 1 {t[0]:.4f} / {t[3]:.4f} ms, launched early "
          f"{t[1]:.4f} / {t[2]:.4f} ms")
    flush = torch.empty(cs.L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    t = [cs.single_call_ms(fn, flush) for fn in (lambda: old_assign(bits), lambda: new_assign(bits))]
    print(f"  pass 2, single calls after an L2 flush: every gt per anchor {t[0]:.4f} ms, culled {t[1]:.4f} ms")
    # the same kernels on inputs that leave the cull nothing: no gt row to test, rows that reach no chunk
    for case in ("no valid gt", "gt outside the range", "every anchor masked"):
        other = cs.matcher_inputs(trainer, batch, case)
        other_bits = mc.gt_max_bits_cuda(tables, *other)
        print(f"  '{case}': pass 1 {cs.cuda_ms(lambda: mc.gt_max_bits_cuda(tables, *other)):.4f} ms, "
              f"pass 2 {cs.cuda_ms(lambda: mc.assign_cuda(tables, *other, other_bits)):.4f} ms")
    outputs = torch.empty(b * a * 10, dtype=torch.int32, device="cuda")
    print(f"  the library's fill of pass 2's {outputs.numel() * 4} output bytes: {cs.cuda_ms(outputs.zero_):.4f} ms")
    shipped = mc._lib()
    want = new_assign(bits)
    for label, lib in libs.items():
        mc._lib = lambda lib=lib: mc.bind(lib)
        try:
            cs.check(torch.equal(new_gt_max(), bits), f"variant '{label}' differs in gt-max")
            cs.check(all(torch.equal(x, y) for x, y in zip(new_assign(bits), want)), f"variant '{label}' differs")
            variant = [cs.cuda_ms(new_gt_max), cs.cuda_ms(lambda: new_assign(bits))]
        finally:
            mc._lib = lambda: shipped
        base = [cs.cuda_ms(new_gt_max), cs.cuda_ms(lambda: new_assign(bits))]
        print(f"  {label}: pass 1 {variant[0]:.4f} ms, pass 2 {variant[1]:.4f} ms (as shipped, right after: "
              f"{base[0]:.4f}, {base[1]:.4f})")


def main(which=("nms", "fence", "matcher", "blocked")) -> int:
    if not torch.cuda.is_available():
        print("kernel_redesigns: no CUDA device", file=sys.stderr)
        return 2
    from det3d_tpu_torch.config import load_config
    from det3d_tpu_torch.data.synthetic import synthetic_cloud
    from det3d_tpu_torch.pipeline import Detector

    print("nvidia-smi:", cs.card_line())
    logs = build.build_all(("nms", "fence", "matcher", "scatter", *build.EXPERIMENT_SOURCES))
    if "blocked" in which:
        for name in ("scatter", *build.EXPERIMENT_SOURCES):
            print("\n".join(line for line in logs[name].splitlines() if "gather_rows_blocked" in line
                            or "registers" in line))
        blocked_old_and_new()
    cfg = load_config("configs/ntusl_20cm.json", max_points=120_000)
    if "matcher" in which:
        print("\n".join(line for line in logs["matcher"].splitlines() if "registers" in line or "Compiling" in line))
        matcher_old_and_new(cfg)
    if "nms" not in which and "fence" not in which:
        return 0
    det = Detector(cfg).init_weights(cs.SEED)
    pts = torch.from_numpy(synthetic_cloud(cfg.max_points, cs.N_POINTS, seed=cs.SEED)).cuda()
    cases = cs.nms_cases(det.infer_candidates(pts, cs.N_POINTS), torch.Generator().manual_seed(cs.SEED + 1))
    thr = det.postprocess.params.nms_iou_threshold
    if "nms" in which:
        nms_old_and_new(thr, [cases[1], cases[4], cases[0]])
        chain_alone()
        sweep_cycles(thr, cases[8][1], cases[8][2])
    if "fence" in which:
        fence_old_and_new()
    return 0


if __name__ == "__main__":
    sys.exit(main(tuple(sys.argv[1:]) or ("nms", "fence", "matcher", "blocked")))
