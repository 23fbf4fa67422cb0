"""Command-line entry points: ``python -m debvader_tpu_torch <command>``.

The JAX package's CLI over the port:

- ``deblend``          stamps .npy -> means (and optional stddevs) .npy
- ``detect``           field .npy -> (N, 2) centre offsets .npy
- ``serve``            field .npy [+ centres] -> catalog .csv + residual .npy
- ``train``            two-stage training on (blended, isolated) .npy
- ``quantize``         calibrate (+ optional QAT) an int8 serving bundle
- ``export``           weights -> torch.export ``.pt2`` artifact
- ``import-weights``   reference TF checkpoint -> weights file

``--weights`` is a survey name of the packaged data ('sim_demo') or a
weights file in the port's ``.npz`` format (what ``train --out`` writes),
with or without its suffix, or a directory holding ``ckpt.npz`` files
(the newest is taken).  Every command runs on ``--device`` (default
'cuda'); without a card it raises unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import csv
import sys
from pathlib import Path

import numpy as np

__all__ = ["main", "build_parser"]


def _model_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--stamp-size", type=int, default=59)
    p.add_argument("--bands", type=int, default=6)
    p.add_argument("--latent", type=int, default=32)
    p.add_argument("--filters", type=int, nargs="+", default=[32, 64, 128, 256])
    p.add_argument(
        "--dtype", default="float32", choices=["float32", "bfloat16"],
        help="compute dtype of the forward; the parameters stay float32",
    )
    p.add_argument(
        "--f32-stages", type=int, default=0, metavar="N",
        help="run the decoder's last N stage pairs (and the band head) in "
        "float32 under a bfloat16 forward",
    )
    p.add_argument(
        "--matmul-precision", default=None, choices=["default", "high", "highest"],
        help="the JAX package's precision rung; float32 on a card unless "
        "the limb emulation is asked for in a ModelConfig",
    )
    p.add_argument(
        "--flux-calibration", action="store_true",
        help="measure the forward's per-band flux gain against its own "
        "float32 'highest' forward at load and divide it out",
    )
    _device_flag(p)


def _device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="where the command runs (default cuda; cpu only when asked)",
    )


def _model_cfg(args):
    from debvader_tpu_torch.config import ModelConfig

    return ModelConfig(
        stamp_size=args.stamp_size,
        nb_of_bands=args.bands,
        latent_dim=args.latent,
        filters=tuple(args.filters),
        kernels=(3,) * len(args.filters),
        dtype=args.dtype,
        decoder_f32_stages=args.f32_stages,
        matmul_precision=args.matmul_precision,
    )


def _weights_path(weights: str | None) -> Path | None:
    """The weights file ``--weights`` names, or None for a survey name."""
    if not weights:
        return None
    for p in (Path(weights), Path(weights + ".npz")):
        if p.is_file():
            return p
    p = Path(weights)
    if p.is_dir():
        found = sorted(p.rglob("ckpt.npz"), key=lambda f: (-f.stat().st_mtime, str(f)))
        if not found:
            raise FileNotFoundError(f"no ckpt.npz under {p}")
        return found[0]
    return None


def _load_net(args):
    from debvader_tpu_torch.device import resolve_device
    from debvader_tpu_torch.models.vae import DeblenderVAE
    from debvader_tpu_torch.weights import load_deblender, load_flax_npz, state_dict_from_flax

    cfg = _model_cfg(args)
    flux_cal = getattr(args, "flux_calibration", False)
    path = _weights_path(args.weights)
    if path is None:
        return load_deblender(args.weights or "sim_demo", device=args.device, cfg=cfg, flux_calibration=flux_cal)
    dev = resolve_device(args.device)
    model = DeblenderVAE(cfg)
    model.load_state_dict(state_dict_from_flax(load_flax_npz(path), cfg))
    model = model.to(dev).eval()
    if flux_cal:
        from debvader_tpu_torch.utils.flux_cal import attach_flux_calibration

        attach_flux_calibration(model)
    return model


def _load_field(path: str) -> np.ndarray:
    field = np.load(path)
    if field.ndim == 3:
        field = field[None]
    return field.astype(np.float32)


def _det_cfg(args):
    from debvader_tpu_torch.config import DetectionConfig

    kw = {}
    if args.thresh is not None:
        kw["thresh"] = args.thresh
    if getattr(args, "detection_band", None) is not None:
        kw["detection_band"] = args.detection_band
    if getattr(args, "deblend_algo", None) is not None:
        kw["deblend_algo"] = args.deblend_algo
    return DetectionConfig(**kw)


def _cmd_deblend(args) -> int:
    import torch

    from debvader_tpu_torch.api import deblend
    from debvader_tpu_torch.device import resolve_device
    from debvader_tpu_torch.models.distributions import PixelNormal

    stamps = np.load(args.stamps).astype(np.float32)
    if stamps.ndim == 3:
        stamps = stamps[None]
    if args.artifact:
        from debvader_tpu_torch.utils.export import artifact_forward

        dev = resolve_device(args.device)
        fwd = artifact_forward(args.artifact, normalise=args.normalise, device=dev)
        dist = PixelNormal(*fwd(stamps, torch.Generator(device=dev).manual_seed(0)))
        means = dist.mean().cpu().numpy()
    else:
        means, dist = deblend(_load_net(args), stamps, normalise=args.normalise, device=args.device)
    np.save(args.out, means)
    print(f"wrote {args.out}: {means.shape}")
    if args.std:
        std = dist.stddev().cpu().numpy()
        np.save(args.std, std)
        print(f"wrote {args.std}: {std.shape}")
    return 0


def _cmd_detect(args) -> int:
    from debvader_tpu_torch.pipeline.tiles import detect_objects_tiled

    field = _load_field(args.field)
    centers = detect_objects_tiled(field, _det_cfg(args), tile=args.tile, overlap=args.overlap, device=args.device)
    np.save(args.out, centers)
    print(f"wrote {args.out}: {len(centers)} detections")
    return 0


def _load_centers(args):
    return np.load(args.centers) if args.centers else None


def _cmd_serve(args) -> int:
    from debvader_tpu_torch.config import PipelineConfig

    net = _load_net(args)
    field = _load_field(args.field)
    quantized = None
    if args.quantized:
        from debvader_tpu_torch.models.quantized import load_quantized

        quantized = load_quantized(args.quantized, device=args.device)
    kw = dict(
        cutout_size=args.stamp_size,
        nb_of_bands=args.bands,
        normalise=args.normalise,
        artifact=args.artifact,
        quantized=quantized,
        # the iterative route's own detection honours --tile / --overlap
        cfg=PipelineConfig(
            cutout_size=args.stamp_size, nb_of_bands=args.bands, tile_size=args.tile, tile_overlap=args.overlap
        ),
        device=args.device,
    )
    timings: dict = {}
    if args.iterative:
        from debvader_tpu_torch.pipeline.iterative import IterativeDeblendField

        df = IterativeDeblendField(net, field, **kw)
        catalog, residual = df.iterative_deblend_and_render(
            _load_centers(args),
            optimise_positions=args.optimise_positions,
            measure=args.measure,
            det_cfg=_det_cfg(args),
            transfer_dtype=args.transfer_dtype,
        )
    else:
        from debvader_tpu_torch.pipeline.field import DeblendField
        from debvader_tpu_torch.pipeline.tiles import detect_objects_tiled

        centers = _load_centers(args)
        if centers is None:
            centers = detect_objects_tiled(
                field, _det_cfg(args), tile=args.tile, overlap=args.overlap, device=args.device
            )
            print(f"detected {len(centers)} sources")
        df = DeblendField(net, field, **kw)
        catalog, residual = df.deblend_and_render(
            centers,
            optimise_positions=args.optimise_positions,
            measure=args.measure,
            timings=timings,
            transfer_dtype=args.transfer_dtype,
        )
    if catalog is None:
        print("no sources deblended")
        return 1
    np.save(f"{args.out_prefix}_residual.npy", residual)
    _write_catalog(catalog, f"{args.out_prefix}_catalog.csv")
    stages = " ".join(f"{k}={v:.2f}s" for k, v in timings.items())
    print(
        f"wrote {args.out_prefix}_catalog.csv ({len(catalog)} rows) and {args.out_prefix}_residual.npy"
        + (f"  stages: {stages}" if stages else "")
    )
    return 0


def _cell(v) -> str:
    v = np.asarray(v).item()
    return repr(v) if isinstance(v, float) else str(v)


def _write_catalog(catalog, path: str) -> None:
    """A catalog record array as CSV, one column per component of a vector
    column (``shifts_0``, ``shifts_1``, ...), as the JAX CLI's pandas
    writer lays it out.  Floats are written to round-trip exactly."""
    columns, names = [], []
    for name in catalog.dtype.names:
        col = catalog[name]
        if col.dtype == object:
            col = np.stack([np.asarray(v) for v in col]) if len(col) else np.zeros((0,))
        col = np.asarray(col)
        if col.ndim > 1:
            flat = col.reshape(len(col), -1)
            for i in range(flat.shape[1]):
                names.append(f"{name}_{i}")
                columns.append(flat[:, i])
        else:
            names.append(name)
            columns.append(col)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(names)
        for row in range(len(catalog)):
            w.writerow([_cell(c[row]) for c in columns])


def _cmd_train(args) -> int:
    from debvader_tpu_torch.training.checkpoint import save_weights
    from debvader_tpu_torch.training.train import train_deblender

    mesh = None
    if args.mesh:
        from debvader_tpu_torch.parallel import initialize_distributed, make_mesh

        # under torchrun (MASTER_ADDR and the rest set) the mesh spans every
        # rank's cards; else N cards, or the CPU repeated N times under
        # --device cpu
        initialize_distributed()
        mesh = make_mesh(args.mesh, devices=None if args.device == "cuda" else [args.device] * args.mesh)
    x = np.load(args.blended).astype(np.float32)
    y = np.load(args.isolated).astype(np.float32)
    n_val = max(int(len(x) * args.val_fraction), 1)
    hist_vae, hist_debl, state, _model = train_deblender(
        args.survey,
        args.from_survey,
        args.epochs,
        training_data_vae=(x[n_val:], y[n_val:]),
        validation_data_vae=(x[:n_val], y[:n_val]),
        training_data_deblender=(x[n_val:], y[n_val:]),
        validation_data_deblender=(x[:n_val], y[:n_val]),
        batch_size=args.batch_size,
        nb_of_bands=args.bands,
        verbose=1,
        metrics_log=args.metrics_log,
        model_cfg=_model_cfg(args),
        steps_per_dispatch=args.steps_per_dispatch,
        device=args.device,
        mesh=mesh,
    )
    if mesh is not None and mesh.spans_processes and mesh.rank != 0:
        return 0  # rank 0 writes the weights
    out = save_weights(args.out, state.variables())
    print(
        f"wrote {out}  (final val loss: vae={hist_vae['val_loss'][-1]:.4g} "
        f"deblender={hist_debl['val_loss'][-1]:.4g})"
    )
    return 0


def _cmd_quantize(args) -> int:
    from debvader_tpu_torch.models.quantized import qat_finetune, quantize_vae, save_quantized

    model = _load_net(args)
    if args.calib_stamps:
        calib = np.load(args.calib_stamps).astype(np.float32)
    else:
        from debvader_tpu_torch.data.simulate import simulate_batch

        cfg = model.cfg
        calib = simulate_batch(11, args.calib_n, stamp=cfg.stamp_size, bands=cfg.nb_of_bands)[0]
    qv = quantize_vae(model, calib, normalise=args.normalise, act_granularity=args.act_granularity)
    if args.qat_steps:
        qv = qat_finetune(
            qv, steps=args.qat_steps, batch=args.qat_batch, learning_rate=args.qat_lr, teacher_variables=qv.model
        )
    save_quantized(qv, args.out)
    qat = f", QAT {args.qat_steps} steps" if args.qat_steps else ""
    print(f"wrote {args.out} (int8 bundle, {len(qv.qweights)} quantized layers{qat})")
    return 0


def _cmd_export(args) -> int:
    from debvader_tpu_torch.utils.export import export_deblender

    blob = export_deblender(_load_net(args), batch_size=args.batch or None, path=args.out)
    print(f"wrote {args.out} ({len(blob)} bytes of torch.export program)")
    return 0


def _cmd_import_weights(args) -> int:
    from debvader_tpu_torch.training.checkpoint import save_weights
    from debvader_tpu_torch.utils.tf_checkpoint import load_available_tensors
    from debvader_tpu_torch.utils.weight_import import import_from_tensors
    from debvader_tpu_torch.weights import flatten_flax

    tree = import_from_tensors(load_available_tensors(args.ckpt), strict=not args.partial)
    out = save_weights(args.out, flatten_flax(tree))
    print(f"wrote {out}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    from debvader_tpu_torch import __version__

    parser = argparse.ArgumentParser(
        prog="debvader_tpu_torch", description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    parser.add_argument("--version", action="version", version=f"debvader_tpu_torch {__version__}")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("deblend", help="batched stamp deblending")
    _model_flags(p)
    p.add_argument("--weights", help="survey name or weights file (default sim_demo)")
    p.add_argument("--artifact", help="serve from an exported .pt2 artifact (see `export`) instead of the weights")
    p.add_argument("--stamps", required=True, help="(N, S, S, B) .npy")
    p.add_argument("--out", required=True, help="output means .npy")
    p.add_argument("--std", help="also write the per-pixel stddev .npy")
    p.add_argument("--normalise", action="store_true")
    p.set_defaults(fn=_cmd_deblend)

    p = sub.add_parser("detect", help="tiled source detection")
    p.add_argument("--field", required=True, help="(F, F, B) or (1, F, F, B) .npy")
    p.add_argument("--out", required=True, help="output centres .npy")
    p.add_argument("--tile", type=int, default=1024)
    p.add_argument("--overlap", type=int, default=64)
    p.add_argument("--thresh", type=float, default=None)
    p.add_argument("--detection-band", type=int, default=None)
    p.add_argument(
        "--deblend-algo", default=None, choices=["watershed", "lutz"],
        help="island splitting: watershed with the quantized merge (default) or the Lutz multi-threshold tree",
    )
    _device_flag(p)
    p.set_defaults(fn=_cmd_detect)

    p = sub.add_parser("serve", help="catalog + residual serving (detects when no centres are given)")
    _model_flags(p)
    p.add_argument("--weights")
    p.add_argument(
        "--artifact",
        help="run the batched stamp forward from an exported .pt2 artifact (the weights still load for "
        "epistemic sampling)",
    )
    p.add_argument("--quantized", help="int8 serving bundle from the `quantize` command")
    p.add_argument("--field", required=True)
    p.add_argument("--centers", help="(N, 2) offsets .npy; omit to detect")
    p.add_argument("--out-prefix", required=True)
    p.add_argument("--iterative", action="store_true")
    p.add_argument("--optimise-positions", action="store_true")
    p.add_argument("--measure", action="store_true")
    p.add_argument("--normalise", action="store_true")
    p.add_argument("--transfer-dtype", choices=["bfloat16", "float16"])
    p.add_argument("--tile", type=int, default=1024)
    p.add_argument("--overlap", type=int, default=64)
    p.add_argument("--thresh", type=float, default=None)
    p.add_argument("--detection-band", type=int, default=None)
    p.add_argument("--deblend-algo", default=None, choices=["watershed", "lutz"])
    p.set_defaults(fn=_cmd_serve)

    p = sub.add_parser("train", help="two-stage training")
    _model_flags(p)
    p.add_argument("--blended", required=True, help="(N, S, S, B) inputs .npy")
    p.add_argument("--isolated", required=True, help="(N, S, S, B) targets .npy")
    p.add_argument("--out", required=True, help="output weights file (.npz)")
    p.add_argument("--survey", default="lsst")
    p.add_argument("--from-survey", default=None, help="warm-start from this survey's weights")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=5)
    p.add_argument("--val-fraction", type=float, default=0.1)
    p.add_argument("--mesh", type=int, help="data-parallel over N devices: N cards, or the CPU N times with "
                   "--device cpu")
    p.add_argument("--metrics-log", help="JSONL epoch metrics path")
    p.add_argument("--steps-per-dispatch", type=int, default=1)
    p.set_defaults(fn=_cmd_train)

    p = sub.add_parser("quantize", help="calibrate (+ optional QAT fine-tune) an int8 serving bundle")
    _model_flags(p)
    p.add_argument("--weights")
    p.add_argument("--out", required=True, help="output bundle (<out>.npz and <out>.json)")
    p.add_argument(
        "--calib-stamps",
        help="(N, S, S, B) .npy of representative stamps; default: the port's simulated stamps from seed 11 "
        "(the JAX CLI draws its own from PRNGKey(11), which torch cannot replay)",
    )
    p.add_argument("--calib-n", type=int, default=128)
    p.add_argument("--qat-steps", type=int, default=0)
    p.add_argument("--qat-batch", type=int, default=256)
    p.add_argument("--qat-lr", type=float, default=1e-4)
    p.add_argument("--act-granularity", default="per_channel", choices=["per_channel", "per_tensor"])
    p.add_argument("--normalise", action="store_true")
    p.set_defaults(fn=_cmd_quantize)

    p = sub.add_parser("export", help="torch.export serving artifact")
    _model_flags(p)
    p.add_argument("--weights")
    p.add_argument("--out", required=True)
    p.add_argument(
        "--batch", type=int, default=0,
        help="0 (default) = symbolic batch dimension: one artifact serves any batch (what `serve --artifact` needs)",
    )
    p.set_defaults(fn=_cmd_export)

    p = sub.add_parser("import-weights", help="reference TF checkpoint -> weights file")
    p.add_argument("--ckpt", required=True, help="TF checkpoint prefix")
    p.add_argument("--out", required=True, help="output weights file (.npz appended if missing); "
                   "--weights takes it, load_deblender(<name>, weights_dir=<its directory>) serves it")
    p.add_argument("--partial", action="store_true",
                   help="write the tensors whose shard is present instead of raising for a missing one")
    p.set_defaults(fn=_cmd_import_weights)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
