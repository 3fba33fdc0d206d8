"""Zero-shot WSI drivers: ``python -m keep_tpu_torch.wsi.run <task> ...``
(counterpart of ``keep_tpu/wsi/run.py``).

The reference's driver scripts (WSI_evaluation/zeroshot_detection_WSI.py,
zeroshot_segmentation_WSI.py, zeroshot_subtyping_WSI.py): load the model
and the prompts, build the prompt-ensemble classifier (screened or seeded
random), sweep one slide or a cohort CSV, print the metrics. ``extract``
writes CLAM-style h5 features from a slide: a pyramidal ``.svs`` / ``.tif``
streams through the native libtiff reader (``io.wsi``), any other image (or
a pyramid the native reader cannot open) is cut whole through PIL.
``extract --int8`` calibrates the visual tower on the slide's first
``--int8-calib`` tiles (SmoothQuant; 0 for plain W8A8). ``detection
--image`` runs the coarse-to-fine cascade straight off a pyramid
(``wsi.cascade``). The flags and defaults are the JAX CLI's, plus
``--device`` (default ``cuda``; without a card the CLI raises unless
``--device cpu`` is passed). ``extract --mesh-dp`` shards the tile axis
over every card (``wsi.extract.extract_features(mesh=)``), extraction only,
as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import json
import logging

import numpy as np
import torch

def _encoder(model, device):
    def encode(ids, mask):
        with torch.inference_mode():
            return model.encode_text(
                torch.from_numpy(np.asarray(ids, np.int64)).to(device),
                torch.from_numpy(np.asarray(mask, np.int64)).to(device))
    return encode


def build_ensemble(model, tokenizer, prompts, label_map, features, args):
    """The prompt-ensemble classifier [D, C] on ``args.device``: the stack
    of every prompt's classifier, screened on ``features`` (top
    ``args.topn``) or summed at seeded-random picks (``--no-screening``)."""
    from keep_tpu_torch.zeroshot import (build_classifiers_batched,
                                         prompt_select, random_ensemble)

    device = torch.device(args.device)
    stack = build_classifiers_batched(
        _encoder(model, device), tokenizer, prompts, label_map,
        add_normal=args.add_normal, batch_size=args.text_batch_size,
        max_length=args.max_length,
        length_buckets=None if args.no_text_buckets else "auto",
        device=device)
    if args.prompt_screening:
        logging.info("screening %d prompt classifiers...", stack.shape[0])
        return prompt_select(stack, torch.as_tensor(features).to(device),
                             topn=args.topn)
    return random_ensemble(stack, topn=args.topn)


def load_model(args, calib_pixels=None):
    """The bf16 model with the fused attention kernels on ``args.device``
    (with ``--int8`` the W8A8 model, SmoothQuant-calibrated on
    ``calib_pixels`` when they are given), and its tokenizer."""
    from keep_tpu_torch.factory import get_tokenizer
    from keep_tpu_torch.models.keep import KEEPModel

    int8 = getattr(args, "int8", False)
    # the JAX CLI turns its flash kernels on only on a TPU; the port's
    # kernels are the card's (on the CPU their plain versions run). A
    # plain --int8 load quantizes the fresh model itself; a calibrated one
    # quantizes a copy of the float model
    model = KEEPModel.from_pretrained(
        args.model, dtype=torch.bfloat16, use_flash=True,
        device=args.device, quantize=int8 and calib_pixels is None)
    if int8 and calib_pixels is not None:
        model = model.quantize(calib_pixels=calib_pixels)
    # the native WordPiece when it builds, as in the JAX package
    return model, get_tokenizer("bert", args.model)


def _try_open_pyramid(path: str):
    """The native reader when the file is a multi-level pyramid (or an
    .svs); None routes the file to the whole-image PIL path, as in the JAX
    package (also when the native reader cannot open it)."""
    if not str(path).lower().endswith((".tif", ".tiff", ".svs")):
        return None
    try:
        from keep_tpu_torch.io.wsi import WSIReader

        reader = WSIReader(path, backend="native")
    except Exception:
        return None
    if reader.level_count > 1 or str(path).lower().endswith(".svs"):
        return reader
    reader.close()
    return None


_flat_cache: dict = {}  # one entry: the --int8 calibration reads the flat
# image that the extraction reads next; it is cut once


def _flat_tiles(args, image_path):
    """Whole-image (PIL) tile cut of a flat slide image, memoised for the
    calibration-then-extraction pair of reads."""
    key = (image_path, args.patch_size, args.tissue_fraction)
    if _flat_cache.get("key") == key:
        return _flat_cache["value"]
    from PIL import Image

    from keep_tpu_torch.io.tiles import cut_tiles

    Image.MAX_IMAGE_PIXELS = None
    img = np.asarray(Image.open(image_path).convert("RGB"))
    tiles, coords = cut_tiles(img, patch_size=args.patch_size,
                              tissue_fraction=args.tissue_fraction)
    logging.info("cut %d tissue tiles (%dpx) from %s", len(tiles),
                 args.patch_size, image_path)
    _flat_cache.clear()
    _flat_cache.update(key=key, value=(tiles, coords))
    return tiles, coords


def _check_wsi_level(args, pyramid, image_path):
    if not 0 <= args.wsi_level < pyramid.level_count:
        pyramid.close()
        raise SystemExit(
            f"error: --wsi-level {args.wsi_level} out of range — "
            f"{image_path} has {pyramid.level_count} level(s)")


def _slide_calib(args, image_path):
    """SmoothQuant calibration pixels from the slide's own first tiles,
    preprocessed as the extraction preprocesses them, on ``args.device``;
    or None."""
    if not (getattr(args, "int8", False) and args.int8_calib):
        return None
    from keep_tpu_torch.ops.preprocess import preprocess

    pyramid = _try_open_pyramid(image_path)
    if pyramid is not None:
        _check_wsi_level(args, pyramid, image_path)
        from keep_tpu_torch.io.tiles import iter_wsi_tiles

        first = next(iter_wsi_tiles(
            pyramid, patch_size=args.patch_size,
            tissue_fraction=args.tissue_fraction,
            chunk=args.int8_calib, level=args.wsi_level), None)
        pyramid.close()
        tiles = first[0] if first is not None else None
    else:
        tiles, _ = _flat_tiles(args, image_path)
        tiles = tiles[: args.int8_calib] if len(tiles) else None
    if tiles is None or not len(tiles):
        return None
    logging.info("int8 calibration on %d tiles", len(tiles))
    return preprocess(torch.from_numpy(np.ascontiguousarray(tiles)).to(
        args.device))


def _extract_one(model, args, image_path, out_path, mesh=None) -> int:
    """One slide → one h5: the streaming native-pyramid path when the file
    is a pyramid, the whole-image PIL path otherwise. Returns the tile
    count."""
    pyramid = _try_open_pyramid(image_path)
    if pyramid is not None:
        _check_wsi_level(args, pyramid, image_path)
        from keep_tpu_torch.wsi.extract import extract_wsi_to_h5

        logging.info("pyramidal slide %s: %d levels, level %d is %s",
                     image_path, pyramid.level_count, args.wsi_level,
                     pyramid.level_dimensions[args.wsi_level])
        pyramid.close()
        return extract_wsi_to_h5(
            model, image_path, out_path, patch_size=args.patch_size,
            tissue_fraction=args.tissue_fraction, level=args.wsi_level,
            batch_size=args.batch_size, resize=True, mesh=mesh)

    from keep_tpu_torch.wsi.extract import extract_to_h5

    tiles, coords = _flat_tiles(args, image_path)
    extract_to_h5(model, tiles, coords, out_path,
                  batch_size=args.batch_size, resize=True, mesh=mesh)
    return len(tiles)


def _cascade(model, tokenizer, prompts, label_map, args) -> None:
    """``detection --image``: the coarse-to-fine cascade straight off the
    pyramid, no h5 needed; the prompts are screened on the coarse level's
    features (the cascade encodes them again inside)."""
    from keep_tpu_torch.io.tiles import iter_wsi_tiles
    from keep_tpu_torch.io.wsi import open_slide
    from keep_tpu_torch.wsi.cascade import cascade_detect
    from keep_tpu_torch.wsi.extract import extract_features

    with open_slide(args.image) as reader:
        level = reader.best_level_for_downsample(args.coarse_downsample)
        coarse = np.concatenate([t for t, _ in iter_wsi_tiles(
            reader, patch_size=args.patch_size,
            tissue_fraction=args.tissue_fraction,
            chunk=args.batch_size, level=level)])
    screen_feats = extract_features(model, coarse, resize=True,
                                    batch_size=args.batch_size)
    classifier = build_ensemble(model, tokenizer, prompts, label_map,
                                screen_feats, args)
    res = cascade_detect(
        model, args.image, classifier, patch_size=args.patch_size,
        coarse_downsample=args.coarse_downsample,
        margin=args.cascade_margin, threshold=args.threshold,
        tissue_fraction=args.tissue_fraction,
        batch_size=args.batch_size, resize=True)
    print(f"Tumor probability: {res.tumor_prob:.4f}")
    print(f"cascade: {res.n_coarse} coarse + {res.n_fine_encoded} fine "
          f"encodes for {res.n_fine_total} tiles "
          f"(encode fraction {res.encode_fraction:.3f}, "
          f"downsample {res.downsample}, margin {args.cascade_margin})")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("task", choices=["detection", "segmentation",
                                         "subtyping", "extract"])
    parser.add_argument("--model", required=True, help="HF model dir (config.json + pytorch_model.bin + vocab.txt)")
    parser.add_argument("--prompts", help="prompt JSON (reference WSI_evaluation/prompts format; required for eval tasks)")
    parser.add_argument("--h5", help="one slide h5 (features+coords)")
    parser.add_argument("--cohort-csv", help="cohort CSV with slide_id/Diagnosis")
    parser.add_argument("--data-source", help="dir containing h5_files/ for the cohort")
    parser.add_argument("--label-map", default='{"Normal": 0, "Tumor": 1}',
                        help="JSON label→index map")
    parser.add_argument("--mask", help="segmentation GT mask (npy at level 0) or OpenSlide path")
    parser.add_argument("--mask-dir", help="cohort segmentation: dir of {slide_id}.npy level-0 masks")
    parser.add_argument("--patch-size", type=int, default=None)
    parser.add_argument("--topn", type=int, default=50)
    parser.add_argument("--no-screening", dest="prompt_screening", action="store_false")
    parser.add_argument("--text-batch-size", type=int, default=256)
    parser.add_argument("--max-length", type=int, default=256)
    parser.add_argument("--no-text-buckets", action="store_true",
                        help="pad every prompt to --max-length instead of "
                             "the measured auto bucketed-vs-flat plan")
    parser.add_argument("--threshold", type=float, default=0.5)
    parser.add_argument("--heatmap-out", metavar="PNG",
                        help="single-slide eval tasks: also save a heatmap "
                        "at patch_size/16 px per patch — tumor prob*255 for "
                        "detection/segmentation, argmax class index + 1 "
                        "for subtyping")
    parser.add_argument("--int8", action="store_true",
                        help="W8A8 quantized inference (keep_tpu_torch.quant)")
    parser.add_argument("--int8-calib", type=int, default=32, metavar="N",
                        help="extract+--int8: SmoothQuant-calibrate the "
                             "visual tower on the slide's first N tiles "
                             "(0 disables; quant.smooth_vit)")
    parser.add_argument("--image", help="extract: level-0 RGB image "
                        "(PIL-readable), or a pyramidal .tif/.svs slide — "
                        "pyramids stream through the native libtiff reader "
                        "(keep_tpu_torch.io.wsi, no OpenSlide); detection: "
                        "a pyramid for the cascade sweep")
    parser.add_argument("--wsi-level", type=int, default=0,
                        help="extract from a pyramid: pyramid level to read "
                             "tiles at (0 = full resolution)")
    parser.add_argument("--slide-dir", help="extract: directory of slides "
                        "(.svs/.tif/.png/...) — cohort mode, one h5 per "
                        "slide under --out-dir/h5_files/")
    parser.add_argument("--out-dir", help="extract --slide-dir: output root "
                        "(h5 tree ready for --data-source cohort eval)")
    parser.add_argument("--out", help="extract: output h5 path (features+coords)")
    parser.add_argument("--tissue-fraction", type=float, default=0.25)
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--cascade-margin", type=float, default=None,
                        metavar="M",
                        help="detection --image: coarse-to-fine cascade — "
                             "refine only coarse tiles within M of the "
                             "decision threshold (0.5 = exact full sweep, "
                             "0 = trust the coarse pass; wsi/cascade.py)")
    parser.add_argument("--coarse-downsample", type=int, default=4,
                        help="cascade: target pyramid downsample for the "
                             "coarse pass (d^2 fewer tiles)")
    parser.add_argument("--mesh-dp", action="store_true",
                        help="extract: shard the tile axis over every card "
                             "(data parallel, the model replicated)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    args = parser.parse_args(argv)
    args.add_normal = args.task == "subtyping"
    if args.patch_size is None:
        args.patch_size = 224 if args.task == "segmentation" else 256
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")

    logging.basicConfig(level=logging.INFO)

    if args.task == "extract":
        # pixels → CLAM-style h5: the feature extraction the reference
        # leaves to CLAM (README.md:74 'precomputed patch features')
        if args.slide_dir:
            if not args.out_dir:
                parser.error("extract --slide-dir needs --out-dir")
        elif not (args.image and args.out):
            parser.error("extract needs --image and --out "
                         "(or --slide-dir and --out-dir)")
        mesh = None
        if args.mesh_dp:
            from keep_tpu_torch.parallel import make_mesh

            # every card (or the device --device names); the model loads on
            # the first and is replicated on the others
            mesh = make_mesh(devices=None if device.type == "cuda"
                             and device.index is None else [device])
            args.device = str(mesh[0])
            logging.info("extraction sharded over %d devices", len(mesh))

        if args.slide_dir:
            # cohort mode: every slide in the dir → <out-dir>/h5_files/
            # <stem>.h5, the tree WSIDataset / --data-source reads; the
            # model loads once
            import glob
            import os

            exts = (".svs", ".tif", ".tiff", ".png", ".jpg", ".jpeg")
            slides = sorted(
                p for p in glob.glob(os.path.join(args.slide_dir, "*"))
                if p.lower().endswith(exts))
            if not slides:
                parser.error(f"no slides ({'/'.join(exts)}) in {args.slide_dir}")
            h5_dir = os.path.join(args.out_dir, "h5_files")
            os.makedirs(h5_dir, exist_ok=True)
            # the model loads once (--int8 calibrates on the first slide)
            model = None
            total = 0
            for path in slides:
                if model is None:
                    model, _ = load_model(
                        args, calib_pixels=_slide_calib(args, path))
                stem = os.path.splitext(os.path.basename(path))[0]
                out = os.path.join(h5_dir, stem + ".h5")
                n = _extract_one(model, args, path, out, mesh)
                # the cache serves only the first slide's calibration and
                # extraction: holding a slide's tiles while the next one is
                # cut would double the host's peak memory
                _flat_cache.clear()
                logging.info("%s: %d tiles -> %s", stem, n, out)
                total += n
            print(f"wrote {total} features across {len(slides)} slides "
                  f"to {h5_dir}")
            return

        model, _ = load_model(args,
                              calib_pixels=_slide_calib(args, args.image))
        n = _extract_one(model, args, args.image, args.out, mesh)
        print(f"wrote {n} features to {args.out}")
        return
    from keep_tpu_torch.io.h5 import WSIDataset, read_h5_slide
    from keep_tpu_torch.wsi import cohort as cohort_mod
    from keep_tpu_torch.wsi.pipelines import (zero_shot_detection,
                                              zero_shot_segment,
                                              zero_shot_subtyping)

    if not args.prompts:
        parser.error(f"{args.task} needs --prompts")
    label_map = json.loads(args.label_map)
    with open(args.prompts) as f:
        prompts = json.load(f)

    if args.task == "detection" and args.image and not args.h5:
        if args.cascade_margin is None:
            parser.error("detection --image runs the cascade sweep; pass "
                         "--cascade-margin (0.5 = exact full sweep) or "
                         "extract features first (task 'extract') and use "
                         "--h5")
        model, tokenizer = load_model(args)
        _cascade(model, tokenizer, prompts, label_map, args)
        return

    if args.h5:
        if args.task == "segmentation" and not args.mask:
            parser.error("segmentation needs --mask (level-0 .npy array "
                         "or an OpenSlide-readable path)")
        model, tokenizer = load_model(args)
        features, coords = read_h5_slide(args.h5)
        feats = torch.from_numpy(np.asarray(features)).to(device)
        classifier = build_ensemble(model, tokenizer, prompts, label_map,
                                    feats, args)
        if args.task == "detection":
            prob = zero_shot_detection(classifier, feats, coords,
                                       patch_size=args.patch_size,
                                       threshold=args.threshold)
            print(f"Tumor probability: {prob:.4f}")
        elif args.task == "segmentation":
            mask = np.load(args.mask) if args.mask.endswith(".npy") else None
            kw = {"mask": mask} if mask is not None else {"mask_path": args.mask}
            auc, dice = zero_shot_segment(classifier, feats, coords,
                                          patch_size=args.patch_size, **kw)
            print(f"AUROC: {auc:.4f}  Dice: {dice:.4f}")
        else:
            label, fractions = zero_shot_subtyping(classifier, feats, coords,
                                                   patch_size=args.patch_size)
            idx_to_class = {v: k for k, v in label_map.items()}
            print(f"Predicted subtype: {idx_to_class.get(label, label)} "
                  f"(fractions {np.round(fractions, 4).tolist()})")
        if args.heatmap_out:
            from PIL import Image

            from keep_tpu_torch.wsi.pipelines import (subtype_class_map,
                                                      tumor_heatmap)

            if args.task == "subtyping":
                hm = subtype_class_map(classifier, feats, coords,
                                       patch_size=args.patch_size)
            else:
                # refined (overlap) for segmentation; detection's rule is
                # overlap=False: each task's own decision semantics
                hm = tumor_heatmap(classifier, feats, coords,
                                   patch_size=args.patch_size,
                                   overlap=args.task == "segmentation")
            Image.fromarray(hm).save(args.heatmap_out)
            print(f"Heatmap ({hm.shape[0]}x{hm.shape[1]}) -> "
                  f"{args.heatmap_out}")
        return

    if not (args.cohort_csv and args.data_source):
        parser.error("provide --h5 for one slide or --cohort-csv + --data-source")
    if args.task == "segmentation" and not args.mask_dir:
        parser.error("cohort segmentation needs --mask-dir "
                     "({slide_id}.npy level-0 masks)")
    import pandas as pd

    model, tokenizer = load_model(args)
    df = pd.read_csv(args.cohort_csv)
    ds = WSIDataset(df, args.data_source, label_map=label_map)
    first = ds[0]
    classifier = build_ensemble(model, tokenizer, prompts, label_map,
                                first["features"], args)

    def slides():  # the screening slide's features are not read twice
        yield first
        for i in range(1, len(ds)):
            yield ds[i]

    if args.task == "detection":
        out = cohort_mod.detection_cohort(classifier, slides(),
                                          patch_size=args.patch_size,
                                          threshold=args.threshold)
    elif args.task == "subtyping":
        out = cohort_mod.subtyping_cohort(classifier, slides(),
                                          patch_size=args.patch_size)
    else:
        import os

        provider = lambda sid: np.load(os.path.join(args.mask_dir, sid + ".npy"))  # noqa: E731
        out = cohort_mod.segmentation_cohort(classifier, slides(), provider,
                                             patch_size=args.patch_size)
    out.pop("per_slide", None)
    print(json.dumps(out, indent=2, default=float))


if __name__ == "__main__":
    main()
