"""Command-line entry points of the port:

    python -m det3d_tpu_torch train  --config configs/ntusl_20cm.json [--synthetic]
    python -m det3d_tpu_torch infer  --config ... [--checkpoint DIR_OR_PTH] [--breakdown] [--batch N]
    python -m det3d_tpu_torch infer  --config ... --exported DIR
    python -m det3d_tpu_torch eval   --config ... --dt dt.pkl --gt gt.pkl
    python -m det3d_tpu_torch export --config ... [--checkpoint DIR_OR_PTH] --out DIR
    python -m det3d_tpu_torch serve  --config ... [--checkpoint ... | --exported DIR] [--replay DIR [--loop]]
    python -m det3d_tpu_torch bench-rpn --config ...
    python -m det3d_tpu_torch import-weights --config ... --torch-ckpt FILE.pth --out DIR [--no-optimizer]
    python -m det3d_tpu_torch export-weights --config ... --checkpoint DIR --out FILE.pth
    python -m det3d_tpu_torch create-info --root DATA_ROOT [--waymo]

    torchrun --nproc-per-node N -m det3d_tpu_torch train|infer ...   (data-parallel on cards 0..N-1)
    torchrun --nproc-per-node N -m det3d_tpu_torch infer --spatial | serve --spatial | train --spatial-shards S

Counterpart of the JAX package's cli.py for these commands, with its flags
where they apply, plus `--device` (default `cuda`, an error without a card;
`--device cpu` runs on the CPU, and there a bf16 config computes in
float32, with a notice, as the JAX CLI does on its CPU backend; `export`
keeps the configured dtype, as the JAX CLI does). `train --device-augment`
runs the global augmentation on the device, inside the step. A config's
`head: "multi"`, and `pack_w` with its `fuse_in_stats` and `split_head`,
run through every command; `import-weights` / `export-weights` refuse a
multi-head config (the reference `.pth` layout has the shared head only).
Under `torchrun`, `train` and `infer` run data-parallel over its world
(`parallel/mesh.make_mesh`: NCCL on `cuda:LOCAL_RANK`, gloo with `--device
cpu`), as the JAX CLI runs over every visible device: `train` shards each
global batch over the ranks, `infer --batch B` each chunk; rank 0 prints
and writes. `infer --spatial` and `serve --spatial` split each frame's
network along x over the world's ranks (`make_spatial_infer`); `train
--spatial-shards S` trains on a (world/S) x S data x spatial grid
(`make_spatial_train`); `serve` runs under `torchrun` with `--spatial`
only. Without `torchrun` every command runs in this one process, and
`--spatial` in a group of this process alone. Not offered yet: view and
tune (ROADMAP).
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="det3d_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add_common(p):
        p.add_argument("--config", default="configs/ntusl_20cm.json")
        p.add_argument("--max-points", type=int, default=None)  # the JSON's unless given
        p.add_argument("--synthetic", action="store_true", help="generated scenes instead of dataset files")
        p.add_argument("--device", default="cuda", help="torch device to run on (default: cuda)")

    p = sub.add_parser("train", help="training loop (reference train.py:23)")
    add_common(p)
    p.add_argument("--steps", type=int, default=10_000_000)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--model-dir", default=None)
    p.add_argument("--save-step", type=int, default=5000)
    p.add_argument("--eval-step", type=int, default=5000)
    p.add_argument("--display-step", type=int, default=50)
    p.add_argument("--eval-frames", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lr", type=float, default=None,
                   help="override the config's learning_rate (also on resume, as the reference, train.py:76)")
    p.add_argument("--device-augment", action="store_true",
                   help="run the global augmentation transforms (flip/rotate/scale/translate) on the device inside "
                   "the step; the host data loader keeps only the per-object noise")
    p.add_argument("--spatial-shards", type=int, default=1,
                   help="hybrid data x spatial parallelism: partition every sample's conv activations spatially over "
                   "this many ranks (ranks/spatial_shards become data-parallel groups; parallel/mesh."
                   "make_spatial_train) — the activation-memory scaling mode for large canvases")

    p = sub.add_parser("infer", help="offline eval + timing (reference train.py:187)")
    add_common(p)
    p.add_argument("--checkpoint", default=None, help="model directory (its latest.pth) or a .pth file")
    p.add_argument("--frames", type=int, default=64)
    p.add_argument("--breakdown", action="store_true")
    p.add_argument("--out", default=None)
    p.add_argument("--approx-topk", action="store_true",
                   help="bucketed approximate pre-NMS top-k instead of the exact default")
    p.add_argument("--batch", type=int, default=1,
                   help="frames per network call (one NMS call per chunk; the last chunk padded)")
    p.add_argument("--exported", default=None, help="run an exported artifact directory instead")
    p.add_argument("--spatial", action="store_true",
                   help="spatially partition each frame's conv stack over all the ranks (parallel/mesh."
                   "make_spatial_infer) — multi-card single-frame latency; mutually exclusive with --batch > 1")

    p = sub.add_parser("eval", help="official mAP from pickled annos (reference eval/)")
    add_common(p)
    p.add_argument("--dt", required=True)
    p.add_argument("--gt", required=True)
    p.add_argument("--range", type=float, default=80.0)

    p = sub.add_parser("export", help="export the detector as one torch.export program (reference train.py:348)")
    add_common(p)
    p.add_argument("--checkpoint", default=None, help="model directory (its latest.pth) or a .pth file")
    p.add_argument("--out", required=True)

    p = sub.add_parser("serve", help="streaming serving loop (reference ros_node.py)")
    add_common(p)
    p.add_argument("--checkpoint", default=None, help="model directory (its latest.pth) or a .pth file")
    p.add_argument("--exported", default=None, help="serve an exported artifact directory (one CUDA graph a frame)")
    p.add_argument("--frames", type=int, default=100)
    p.add_argument("--hz", type=float, default=10.0)
    p.add_argument("--replay", default=None, metavar="DIR",
                   help="replay the raw .bin point clouds of DIR at --hz instead of the synthetic sensor")
    p.add_argument("--loop", action="store_true", help="with --replay: cycle the directory until --frames")
    p.add_argument("--spatial", action="store_true",
                   help="serve each frame spatially partitioned over all the ranks (parallel/mesh.make_spatial_infer)")

    p = sub.add_parser("bench-rpn", help="RPN microbenchmark, dense and packed (reference rpn_builder.py)")
    add_common(p)
    p.add_argument("--iters", type=int, default=100)

    p = sub.add_parser("import-weights",
                       help="check a reference .pth against the model and write it as a model directory")
    add_common(p)
    p.add_argument("--torch-ckpt", required=True, help="reference .pth file")
    p.add_argument("--out", required=True, help="model directory to write")
    p.add_argument("--no-optimizer", action="store_true", help="drop Adam's moments (resume with a fresh optimizer)")

    p = sub.add_parser("export-weights", help="write a model directory's latest checkpoint as one reference .pth")
    add_common(p)
    p.add_argument("--checkpoint", required=True, help="model directory (or a .pth file)")
    p.add_argument("--out", required=True, help=".pth file to write")

    p = sub.add_parser("create-info", help="dataset indexer (reference create_info.py)")
    p.add_argument("--root", required=True)
    p.add_argument("--out", default=None)
    p.add_argument("--waymo", action="store_true")
    p.add_argument("--num-features", type=int, default=4)

    args = ap.parse_args(argv)

    if args.cmd == "create-info":
        from det3d_tpu_torch.data.create_info import create_info

        create_info(args.root, out_path=args.out, waymo=args.waymo, num_features=args.num_features)
        return

    from det3d_tpu_torch.config import load_config
    from det3d_tpu_torch.utils.device import resolve_device

    overrides = {} if args.max_points is None else {"max_points": args.max_points}
    cfg = load_config(args.config, **overrides)
    device = resolve_device(args.device)  # no card and no --device cpu: an error, before any work
    if (args.cmd in ("train", "infer", "serve", "bench-rpn") and device.type == "cpu"
            and cfg.compute_dtype in ("bfloat16", "bf16")):
        # the CPU parity runs compare float32 with float32, as the JAX CLI's
        # CPU backend does (it has no bf16 dot)
        print(f"{args.cmd} on cpu: promoting compute_dtype bfloat16 -> float32")
        cfg = cfg.replace(compute_dtype="float32")

    mesh = None
    if args.cmd in ("train", "infer", "serve"):
        from det3d_tpu_torch.parallel.mesh import launched_by_torchrun, make_mesh

        spatial = getattr(args, "spatial", False)
        if launched_by_torchrun():
            if args.cmd == "serve" and not spatial:
                raise ValueError("serve runs under torchrun with --spatial only")
            mesh = make_mesh(device=device)
        elif spatial:
            mesh = make_mesh(device=device, rank=0, world_size=1)  # a group of this process alone
    try:
        _run(args, cfg, device, mesh)
        if mesh is not None:
            mesh.barrier()  # no rank leaves while another still works
    finally:
        if mesh is not None:
            import torch.distributed

            torch.distributed.destroy_process_group()


def _run(args, cfg, device, mesh) -> None:
    if args.cmd == "train":
        if args.batch_size:
            cfg = cfg.replace(batch_size=args.batch_size)
        if args.lr is not None:
            cfg = cfg.replace(learning_rate=args.lr)
        from det3d_tpu_torch.apps.train_app import train

        train(cfg, max_steps=args.steps, display_step=args.display_step, save_step=args.save_step,
              eval_step=args.eval_step, eval_frames=args.eval_frames, synthetic=args.synthetic,
              model_dir=args.model_dir, seed=args.seed, device_augment=args.device_augment, device=device,
              mesh=mesh, spatial_shards=args.spatial_shards)
    elif args.cmd == "infer":
        from det3d_tpu_torch.apps.infer_app import infer

        infer(cfg, checkpoint=args.checkpoint, synthetic=args.synthetic, num_frames=args.frames,
              breakdown=args.breakdown, out_path=args.out, approx_topk=args.approx_topk, batch=args.batch,
              exported=args.exported, device=device, mesh=mesh, spatial=args.spatial)
    elif args.cmd == "export":
        from det3d_tpu_torch.deploy.export import export_detector

        export_detector(cfg, checkpoint=args.checkpoint, out_dir=args.out, device=device)
    elif args.cmd == "serve":
        from det3d_tpu_torch.apps import serve_app

        kw = dict(checkpoint=args.checkpoint, exported=args.exported, hz=args.hz, frames=args.frames, device=device,
                  spatial=mesh)
        if args.replay:
            serve_app.serve_replay(cfg, args.replay, loop=args.loop, **kw)
        else:
            serve_app.serve_synthetic(cfg, **kw)
    elif args.cmd == "bench-rpn":
        from det3d_tpu_torch.deploy.rpn_bench import bench_rpn

        bench_rpn(cfg, iters=args.iters, device=device)
    elif args.cmd == "import-weights":
        from det3d_tpu_torch.deploy.torch_interop import import_torch_checkpoint

        step = import_torch_checkpoint(args.torch_ckpt, cfg, args.out, import_optimizer=not args.no_optimizer)
        print(f"imported step {step}: {args.torch_ckpt} -> {args.out} (restore with --checkpoint)")
    elif args.cmd == "export-weights":
        from det3d_tpu_torch.deploy.torch_interop import export_torch_checkpoint

        step = export_torch_checkpoint(args.checkpoint, cfg, args.out)
        print(f"exported step {step}: {args.checkpoint} -> {args.out} (reference-layout .pth)")
    else:
        import pickle

        from det3d_tpu_torch.eval.ap import get_official_eval_result

        with open(args.dt, "rb") as f:
            dt_annos = pickle.load(f)
        with open(args.gt, "rb") as f:
            gt_annos = pickle.load(f)
        _, s = get_official_eval_result(gt_annos, dt_annos, list(cfg.detect_class), args.range, device=device)
        print(s)


if __name__ == "__main__":
    main()
