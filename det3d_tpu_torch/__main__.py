"""`python -m det3d_tpu_torch {train, infer, eval, export, serve, bench-rpn, import-weights,
export-weights, create-info}` (see cli.py)."""

from det3d_tpu_torch.cli import main

if __name__ == "__main__":
    main()
