"""Command-line entry points of the port:

    python -m det3d_tpu_torch train  --config configs/ntusl_20cm.json [--synthetic]
    python -m det3d_tpu_torch infer  --config ... [--checkpoint DIR_OR_PTH] [--breakdown]
    python -m det3d_tpu_torch eval   --config ... --dt dt.pkl --gt gt.pkl
    python -m det3d_tpu_torch create-info --root DATA_ROOT [--waymo]

Counterpart of the JAX package's cli.py for these four commands, with its
flags where they apply, plus `--device` (default `cuda`; `--device cpu`
runs on the CPU, and there a bf16 config computes in float32, with a
notice, as the JAX CLI does on its CPU backend). Not offered yet: export,
serve, view, bench-rpn, tune (ROADMAP); import-weights and export-weights
fall away, because the port's checkpoint is the reference `.pth`.
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

    p = sub.add_parser("infer", help="offline eval + timing (reference train.py:187)")
    add_common(p)
    p.add_argument("--checkpoint", default=None, help="model directory (its latest.pth) or a .pth file")
    p.add_argument("--frames", type=int, default=64)
    p.add_argument("--breakdown", action="store_true")
    p.add_argument("--out", default=None)
    p.add_argument("--approx-topk", action="store_true",
                   help="bucketed approximate pre-NMS top-k instead of the exact default")

    p = sub.add_parser("eval", help="official mAP from pickled annos (reference eval/)")
    add_common(p)
    p.add_argument("--dt", required=True)
    p.add_argument("--gt", required=True)
    p.add_argument("--range", type=float, default=80.0)

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

    overrides = {} if args.max_points is None else {"max_points": args.max_points}
    cfg = load_config(args.config, **overrides)
    if args.cmd in ("train", "infer") and args.device == "cpu" and cfg.compute_dtype in ("bfloat16", "bf16"):
        # the CPU parity runs compare float32 with float32, as the JAX CLI's
        # CPU backend does (it has no bf16 dot)
        print(f"{args.cmd} on cpu: promoting compute_dtype bfloat16 -> float32")
        cfg = cfg.replace(compute_dtype="float32")

    if args.cmd == "train":
        if args.batch_size:
            cfg = cfg.replace(batch_size=args.batch_size)
        if args.lr is not None:
            cfg = cfg.replace(learning_rate=args.lr)
        from det3d_tpu_torch.apps.train_app import train

        train(cfg, max_steps=args.steps, display_step=args.display_step, save_step=args.save_step,
              eval_step=args.eval_step, eval_frames=args.eval_frames, synthetic=args.synthetic,
              model_dir=args.model_dir, seed=args.seed, device=args.device)
    elif args.cmd == "infer":
        from det3d_tpu_torch.apps.infer_app import infer

        infer(cfg, checkpoint=args.checkpoint, synthetic=args.synthetic, num_frames=args.frames,
              breakdown=args.breakdown, out_path=args.out, approx_topk=args.approx_topk, device=args.device)
    else:
        import pickle

        from det3d_tpu_torch.eval.ap import get_official_eval_result

        with open(args.dt, "rb") as f:
            dt_annos = pickle.load(f)
        with open(args.gt, "rb") as f:
            gt_annos = pickle.load(f)
        _, s = get_official_eval_result(gt_annos, dt_annos, list(cfg.detect_class), args.range, device=args.device)
        print(s)


if __name__ == "__main__":
    main()
