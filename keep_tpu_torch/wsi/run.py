"""Zero-shot WSI drivers: ``python -m keep_tpu_torch.wsi.run <task> ...``
(counterpart of ``keep_tpu/wsi/run.py``).

The reference's driver scripts (WSI_evaluation/zeroshot_detection_WSI.py,
zeroshot_segmentation_WSI.py, zeroshot_subtyping_WSI.py): load the model
and the prompts, build the prompt-ensemble classifier (screened or seeded
random), sweep one slide or a cohort CSV, print the metrics. ``extract``
cuts tissue tiles from flat slide images (PIL-readable) and writes
CLAM-style h5 features. The flags and defaults are the JAX CLI's, plus
``--device`` (default ``cuda``; without a card the CLI raises unless
``--device cpu`` is passed).

Not ported yet, and refused with the ROADMAP item that brings them:
pyramidal ``.svs`` / ``.tif`` slides and ``extract_wsi_to_h5`` (the native
pyramid reader) and the coarse-to-fine cascade that reads them
(``detection --image``, ``--cascade-margin``), both item 13; ``--mesh-dp``
(item 10) and SmoothQuant calibration (``extract --int8`` with
``--int8-calib`` > 0; item 7).
"""

from __future__ import annotations

import argparse
import json
import logging

import numpy as np
import torch

from keep_tpu_torch.wsi.pipelines import NATIVE_READER_ITEM as NATIVE_READER

CASCADE = ("ROADMAP queue 1, item 13: the cascade sweep "
           "(keep_tpu/wsi/cascade.py), which reads pyramids")
MESH = "ROADMAP queue 1, item 10: distributed"
CALIBRATION = "ROADMAP queue 1, item 7: SmoothQuant calibration"


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


def load_model(args):
    """The bf16 model with the fused attention kernels on ``args.device``
    (the int8 W8A8 model with ``--int8``), and its tokenizer."""
    from keep_tpu_torch.models.keep import KEEPModel
    from keep_tpu_torch.text.tokenizer import WordPieceTokenizer

    # the JAX CLI turns its flash kernels on only on a TPU; the port's
    # kernels are the card's (on the CPU their plain versions run)
    model = KEEPModel.from_pretrained(
        args.model, dtype=torch.bfloat16, use_flash=True,
        device=args.device, quantize=getattr(args, "int8", False))
    return model, WordPieceTokenizer.from_pretrained(args.model)


def _is_pyramid(path: str) -> bool:
    """An .svs, or a .tif / .tiff with more than one page (a pyramid's
    levels); a single-page TIFF is a flat image."""
    low = str(path).lower()
    if low.endswith(".svs"):
        return True
    if not low.endswith((".tif", ".tiff")):
        return False
    from PIL import Image

    try:
        with Image.open(path) as im:
            return getattr(im, "n_frames", 1) > 1
    except Exception:  # not a TIFF PIL reads: leave it to the native reader
        return True


def _flat_tiles(args, image_path):
    """Whole-image (PIL) tile cut of a flat slide image."""
    from PIL import Image

    from keep_tpu_torch.io.tiles import cut_tiles

    Image.MAX_IMAGE_PIXELS = None
    img = np.asarray(Image.open(image_path).convert("RGB"))
    tiles, coords = cut_tiles(img, patch_size=args.patch_size,
                              tissue_fraction=args.tissue_fraction)
    logging.info("cut %d tissue tiles (%dpx) from %s", len(tiles),
                 args.patch_size, image_path)
    return tiles, coords


def _extract_one(model, args, image_path, out_path) -> int:
    """One flat slide image → one h5. Returns the tile count."""
    from keep_tpu_torch.wsi.extract import extract_to_h5

    tiles, coords = _flat_tiles(args, image_path)
    extract_to_h5(model, tiles, coords, out_path,
                  batch_size=args.batch_size, resize=True)
    return len(tiles)


def _refuse(parser, args) -> None:
    """Refuses, before any work, what the port does not run yet."""
    if args.mesh_dp:
        parser.error(f"--mesh-dp is not ported yet ({MESH})")
    if args.cascade_margin is not None:
        parser.error(f"--cascade-margin runs the cascade sweep, which is not "
                     f"ported yet ({CASCADE})")
    if args.task == "detection" and args.image and not args.h5:
        parser.error(f"detection --image runs the cascade sweep, which is not "
                     f"ported yet ({CASCADE}); extract features first (task "
                     f"'extract') and pass --h5")
    if args.task == "extract" and args.int8 and args.int8_calib:
        parser.error(f"extract --int8 calibrates the visual tower on the "
                     f"slide's first {args.int8_calib} tiles, and SmoothQuant "
                     f"calibration is not ported yet ({CALIBRATION}); pass "
                     f"--int8-calib 0 for plain W8A8")
    if args.task == "extract":
        if args.image and _is_pyramid(args.image):
            parser.error(f"{args.image} is a pyramidal slide, which needs "
                         f"{NATIVE_READER}, not ported yet; pass a flat "
                         f"(single-level) image")


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
                        help="extract+--int8: SmoothQuant calibration on the "
                             "slide's first N tiles; not ported yet, pass 0")
    parser.add_argument("--image", help="extract: level-0 RGB image "
                        "(PIL-readable, flat; pyramidal slides are not "
                        "ported yet)")
    parser.add_argument("--wsi-level", type=int, default=0,
                        help="extract from a pyramid: pyramid level to read "
                             "tiles at (pyramids are not ported yet)")
    parser.add_argument("--slide-dir", help="extract: directory of slide "
                        "images (.png/.jpg/.tif/...) — cohort mode, one h5 "
                        "per slide under --out-dir/h5_files/")
    parser.add_argument("--out-dir", help="extract --slide-dir: output root "
                        "(h5 tree ready for --data-source cohort eval)")
    parser.add_argument("--out", help="extract: output h5 path (features+coords)")
    parser.add_argument("--tissue-fraction", type=float, default=0.25)
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--cascade-margin", type=float, default=None,
                        metavar="M",
                        help="detection --image: the coarse-to-fine cascade "
                             "(not ported yet)")
    parser.add_argument("--coarse-downsample", type=int, default=4,
                        help="cascade: target pyramid downsample for the "
                             "coarse pass (not ported yet)")
    parser.add_argument("--mesh-dp", action="store_true",
                        help="extract: shard the tile axis over a device "
                             "mesh (not ported yet)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")
    args = parser.parse_args(argv)
    args.add_normal = args.task == "subtyping"
    if args.patch_size is None:
        args.patch_size = 224 if args.task == "segmentation" else 256
    _refuse(parser, args)
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
            pyramids = [p for p in slides if _is_pyramid(p)]
            if pyramids:
                parser.error(f"{pyramids[0]} is a pyramidal slide, which "
                             f"needs {NATIVE_READER}, not ported yet")
            h5_dir = os.path.join(args.out_dir, "h5_files")
            os.makedirs(h5_dir, exist_ok=True)
            model, _ = load_model(args)
            total = 0
            for path in slides:
                stem = os.path.splitext(os.path.basename(path))[0]
                out = os.path.join(h5_dir, stem + ".h5")
                n = _extract_one(model, args, path, out)
                logging.info("%s: %d tiles -> %s", stem, n, out)
                total += n
            print(f"wrote {total} features across {len(slides)} slides "
                  f"to {h5_dir}")
            return

        model, _ = load_model(args)
        n = _extract_one(model, args, args.image, args.out)
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
