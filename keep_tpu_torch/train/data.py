"""Training data pipeline: semantic-group sampling, DO-hierarchy captions and
word dropout, producing group-blocked batches (counterpart of
``keep_tpu/train/data.py``).

Host-side numpy and PIL, with the same numpy RNG calls in the same order as
the JAX package, so that one seed gives the same batches in both. Batches
are numpy arrays; the trainer moves them to the device."""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Callable, Iterator, Optional

import numpy as np

from keep_tpu_torch.utils.prefetch import Prefetcher  # noqa: F401

HIERARCHY_TEMPLATES = [
    "CLASSNAME.",
    "a photomicrograph showing CLASSNAME.",
    "a photomicrograph of CLASSNAME.",
    "an image of CLASSNAME.",
    "an image showing CLASSNAME.",
    "an example of CLASSNAME.",
    "CLASSNAME is shown.",
    "this is CLASSNAME.",
    "there is CLASSNAME.",
    "a histopathological image showing CLASSNAME.",
    "a histopathological image of CLASSNAME.",
    "a histopathological photograph of CLASSNAME.",
    "a histopathological photograph showing CLASSNAME.",
    "shows CLASSNAME.",
    "presence of CLASSNAME.",
    "CLASSNAME is present.",
    "an H&E stained image of CLASSNAME.",
    "an H&E stained image showing CLASSNAME.",
    "an H&E image showing CLASSNAME.",
    "an H&E image of CLASSNAME.",
    "CLASSNAME, H&E stain.",
    "CLASSNAME, H&E.",
]

# the 8 top-level Disease Ontology categories that end the ancestor walk
SUB_DISEASE_ROOTS = {
    "DOID:0050117": "disease by infectious agent",
    "DOID:7": "disease of anatomical entity",
    "DOID:14566": "disease of cellular proliferation",
    "DOID:150": "disease of mental health",
    "DOID:0014667": "disease of metabolism",
    "DOID:630": "genetic disease",
    "DOID:0080015": "physical disorder",
    "DOID:225": "syndrome",
}

NORMAL_NAMES = ["normal tissue", "non-cancerous tissue", "non-tumor tissue"]


def load_knowledge_json(path: str) -> dict:
    """DO-graph loader that tolerates trailing commas."""
    with open(path) as f:
        text = f.read()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        return json.loads(re.sub(r",(\s*[}\]])", r"\1", text))


def random_hierarchy(nodes: dict, node_id: str, rng: np.random.Generator,
                     use_syn: bool = False) -> list[str]:
    """Random ancestor name path from ``node_id`` up to a top-level root:
    leaf first, the root itself excluded. 'normal' gives all three normal
    names."""
    if node_id == "normal":
        return list(NORMAL_NAMES)

    def pick_name(nid):
        names = [nodes[nid]["name"]]
        if use_syn:
            names = names + list(nodes[nid].get("synonyms", []))
        return names[rng.integers(0, len(names))]

    path = [pick_name(node_id)]
    cur = node_id
    if cur in SUB_DISEASE_ROOTS:
        return path
    while nodes[cur].get("parent"):
        parents = nodes[cur]["parent"]
        cur = parents[rng.integers(0, len(parents))]
        if cur in SUB_DISEASE_ROOTS:
            break
        path.append(pick_name(cur))
    return path


def hierarchy_caption(nodes: dict, node_id: str, rng: np.random.Generator,
                      use_syn: bool = False, mixed: bool = False) -> str:
    """Templated caption from the reversed ancestor path; ``mixed`` picks
    the leaf name alone half the time."""
    names = random_hierarchy(nodes, node_id, rng, use_syn)
    template = HIERARCHY_TEMPLATES[rng.integers(0, len(HIERARCHY_TEMPLATES))]
    full = template.replace("CLASSNAME", " ".join(names[::-1]))
    leaf = template.replace("CLASSNAME", names[0])
    if mixed and rng.random() <= 0.5:
        return leaf
    return full


def word_dropout(sentence: str, rng: np.random.Generator,
                 p: float = 0.4) -> str:
    """50% no-op; else blank round(p·len) word slots drawn with replacement,
    collapsing double spaces."""
    if rng.random() < 0.5:
        return sentence.replace("  ", " ")
    words = sentence.split(" ")
    drop_len = round(len(words) * p)
    for i in rng.integers(0, len(words), size=drop_len):
        words[i] = ""
    return " ".join(words).replace("  ", " ").lstrip(" ")


def random_crop(img: np.ndarray, size: int,
                rng: np.random.Generator) -> np.ndarray:
    """RandomCrop(size, pad_if_needed) on uint8 HWC."""
    h, w = img.shape[:2]
    if h < size or w < size:
        ph, pw = max(size - h, 0), max(size - w, 0)
        img = np.pad(img, ((ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2),
                           (0, 0)))
        h, w = img.shape[:2]
    top = int(rng.integers(0, h - size + 1))
    left = int(rng.integers(0, w - size + 1))
    return img[top: top + size, left: left + size]


@dataclasses.dataclass
class GroupSample:
    image: str  # image file name (relative to img_dir)
    text: str
    cap_label: str  # DO node id ('unknown' when unlabeled)


class GroupDataset:
    """Semantic-group dataset with per-epoch caption resampling: each epoch
    draws one caption per (group, instance), ``num_instance`` consecutive
    samples per group, so batches are group-blocked for HyMetricLoss."""

    def __init__(self, groups_json: str | dict, num_instance: int,
                 knowledge_json: Optional[str | dict] = None,
                 text_drop: bool = True, labeled_cap: str = "both",
                 seed: int = 0):
        if isinstance(groups_json, str):
            with open(groups_json) as f:
                groups_json = json.load(f)
        self.data = groups_json
        self.nodes = (load_knowledge_json(knowledge_json)
                      if isinstance(knowledge_json, str) else knowledge_json)
        self.num_instance = num_instance
        self.text_drop = text_drop
        self.seed = seed
        self.process_index = 0  # every rank: the JAX package's shard 0 of 1
        self.rng = np.random.default_rng(seed + self.process_index)
        groups = list(self.data.keys())
        if labeled_cap in ("label", "unlabel"):
            want = labeled_cap == "label"
            groups = [g for g in groups
                      if bool(self.data[g].get("labels")) == want]
        self.groups = groups
        self.resample_epoch()

    def __len__(self) -> int:
        return len(self.groups) * self.num_instance

    def _captions(self, group: str) -> list[str]:
        g = self.data[group]
        return list(g.get("merged_caption") or g["captions"])

    def resample_epoch(self, epoch: Optional[int] = None) -> None:
        """Shuffle groups and resample one caption per (group, instance).
        With ``epoch`` the RNG is reseeded per epoch, so a resumed run sees
        the data an uninterrupted run would."""
        if epoch is not None:
            self.rng = np.random.default_rng(
                (self.seed, self.process_index, epoch))
            self.groups = sorted(self.groups)
        self.groups = [self.groups[i]
                       for i in self.rng.permutation(len(self.groups))]
        self._samples: list[GroupSample] = []
        for group in self.groups:
            caps = self._captions(group)
            for _ in range(self.num_instance):
                text = caps[self.rng.integers(0, len(caps))]
                if self.text_drop:
                    text = word_dropout(text, self.rng)
                self._samples.append(GroupSample("", text, ""))

    def __getitem__(self, idx: int) -> GroupSample:
        group = self.groups[idx // self.num_instance]
        s = self._samples[idx]
        g = self.data[group]
        img_list = g["images"]
        if isinstance(img_list, dict):
            img_list = img_list["images"]
        image = img_list[self.rng.integers(0, len(img_list))]
        text, cap_label = s.text, "unknown"
        if self.nodes is not None:
            labels = list(g.get("labels", {}).keys())
            if labels:
                cap_label = labels[self.rng.integers(0, len(labels))]
            if cap_label != "unknown":
                hier = hierarchy_caption(self.nodes, cap_label, self.rng,
                                         use_syn=True, mixed=True)
                if self.rng.integers(0, 2) == 0:
                    text = hier
        return GroupSample(image, text, cap_label)


class CsvTextImageDataset:
    """A CSV of image / caption pairs: the eval sets' format. ``sep='both'``
    reads comma-separated and falls back to tab-separated when that gives
    the wrong columns; ``text_drop`` applies word dropout."""

    def __init__(self, path: str, img_key: str = "image_name",
                 caption_key: str = "caption", sep: str = "|",
                 text_drop: bool = False, seed: int = 0):
        import pandas as pd

        if sep == "both":
            try:
                df = pd.read_csv(path)
                df[img_key]
            except (KeyError, pd.errors.ParserError):
                # the comma parse gave the wrong columns; anything else (IO,
                # encoding) propagates
                df = pd.read_csv(path, sep="\t", engine="python")
        else:
            df = pd.read_csv(path, sep=sep, engine="python")
        self.images = [str(x) for x in df[img_key].tolist()]
        self.captions = [str(x) for x in df[caption_key].tolist()]
        self.text_drop = text_drop
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, idx: int) -> GroupSample:
        text = self.captions[idx]
        if self.text_drop:
            text = word_dropout(text, self.rng)
        return GroupSample(self.images[idx], text, "unknown")


def resolve_image_path(img_dir: str, name: str) -> str:
    """Flat path, or the nested ``<prefix>/<name>`` layout when the flat
    file is absent."""
    path = os.path.join(img_dir, name)
    if not os.path.exists(path):
        path = os.path.join(img_dir, name.split("-")[0], name)
    return path


def load_image(img_dir: str, name: str) -> np.ndarray:
    """uint8 HWC RGB: the native JPEG / PNG decoder (``io.fast_decode``,
    PIL's bits), PIL for anything it declines or where it cannot be
    built."""
    path = resolve_image_path(img_dir, name)
    try:
        from keep_tpu_torch.io.fast_decode import decode_image

        return decode_image(path)
    except Exception:
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))


def dataset_image_names(dataset) -> list[str]:
    """Every image file name a dataset can draw (unique, first-seen
    order)."""
    if isinstance(dataset, GroupDataset):
        names: list[str] = []
        for group in dataset.groups:
            imgs = dataset.data[group]["images"]
            if isinstance(imgs, dict):
                imgs = imgs["images"]
            names.extend(str(i) for i in imgs)
    elif isinstance(dataset, CsvTextImageDataset):
        names = list(dataset.images)
    else:
        raise TypeError(f"unsupported dataset type {type(dataset).__name__}")
    return list(dict.fromkeys(names))


def preload_images(dataset, img_dir: str,
                   workers: int = 8) -> dict[str, np.ndarray]:
    """Every image the dataset can draw, decoded once: name → uint8 HWC, in
    one batched native decode (C++ threads, PIL inside for what it
    declines)."""
    from keep_tpu_torch.io.fast_decode import decode_files

    names = dataset_image_names(dataset)
    arrays = decode_files([resolve_image_path(img_dir, n) for n in names],
                          workers=workers)
    return dict(zip(names, arrays))


@dataclasses.dataclass
class BatchIterator:
    """Group-blocked batches of numpy arrays: pixels [B, S, S, 3]
    (normalised fp32), input_ids / attention_mask [B, L], node_connection
    [N_id, N_id] (when ``do_graph`` is given), and the raw texts and
    labels.

    ``shard = (r, n)``: rank r of n takes rows [r·B/n, (r+1)·B/n) of each
    batch that one process draws from the same seed (``batch_size`` is the
    global batch; ValueError naming it when it does not divide). The RNG
    runs through every row, so the rows equal the one-process batch's;
    only the rank's own images are decoded (the others' sizes, which the
    random crop draws on, come from the preload or from the image file's
    header; a custom ``image_loader`` is called for them). ``texts``,
    ``cap_labels`` and ``node_connection`` stay the global batch's."""

    dataset: GroupDataset
    tokenizer: Callable
    img_dir: str
    batch_size: int
    caption_num: int
    image_size: int = 224
    max_length: int = 256
    do_graph: Optional[object] = None
    image_loader: Optional[Callable[[str], np.ndarray]] = None
    preload: Optional[dict] = None  # name → array, from preload_images()
    drop_last: bool = True
    seed: int = 0
    workers: int = 8  # image decode threads
    shard: tuple[int, int] = (0, 1)  # (rank, ranks) splitting each batch

    def __post_init__(self):
        if self.batch_size % self.caption_num:
            raise ValueError(f"batch_size {self.batch_size} is not a "
                             f"multiple of caption_num {self.caption_num}")
        rank, ranks = self.shard
        if self.batch_size % ranks:
            raise ValueError(f"batch_size {self.batch_size} (the global "
                             f"batch) does not divide over {ranks} ranks")
        n_ins = self.batch_size // self.caption_num
        ds_ins = getattr(self.dataset, "num_instance", None)
        if ds_ins is not None and ds_ins != n_ins:
            raise ValueError(
                f"dataset.num_instance={ds_ins} != batch_size/caption_num="
                f"{n_ins} — group blocks would straddle batch slots")
        self.rng = np.random.default_rng(self.seed)
        self.num_batches = len(self.dataset) // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        from concurrent.futures import ThreadPoolExecutor

        import torch

        from keep_tpu_torch.ops.preprocess import normalize_only

        n = len(self.dataset)
        n_ins = self.batch_size // self.caption_num
        base = self.image_loader or (lambda name: load_image(self.img_dir,
                                                             name))
        if self.preload is not None:
            pre = self.preload
            loader = lambda name: pre[name] if name in pre else base(name)
        else:
            loader = base
        rank, ranks = self.shard
        per_rank = self.batch_size // ranks
        own = range(rank * per_rank, (rank + 1) * per_rank)
        pool = (ThreadPoolExecutor(max_workers=self.workers)
                if self.workers > 1 else None)
        try:
            for start in range(
                    0, n - (self.batch_size - 1 if self.drop_last else 0),
                    self.batch_size):
                idxs = range(start, min(start + self.batch_size, n))
                samples = [self.dataset[i] for i in idxs]
                mine = samples if ranks == 1 else [samples[i] for i in own
                                                   if i < len(samples)]
                if pool is not None:
                    raw = list(pool.map(lambda s: loader(s.image), mine))
                else:
                    raw = [loader(s.image) for s in mine]
                crops = iter(raw)
                pixels = []
                for i, s in enumerate(samples):
                    if ranks == 1 or i in own:
                        pixels.append(random_crop(next(crops),
                                                  self.image_size, self.rng))
                    else:  # the draws the crop would make, in order
                        _skip_crop(self._image_hw(s.image, loader),
                                   self.image_size, self.rng)
                enc = self.tokenizer([s.text for s in samples],
                                     max_length=self.max_length)
                rows = slice(own.start, own.stop) if ranks > 1 else slice(None)
                batch = {
                    "pixels": normalize_only(torch.from_numpy(
                        np.stack(pixels))).numpy(),
                    "input_ids": np.asarray(enc["input_ids"])[rows],
                    "attention_mask": np.asarray(enc["attention_mask"])[rows],
                    "texts": [s.text for s in samples],
                    "cap_labels": [s.cap_label for s in samples],
                }
                if self.do_graph is not None:
                    unique = [s.cap_label for s in samples][::n_ins]
                    batch["node_connection"] = self.do_graph.node_connection(
                        unique)
                yield batch
        finally:
            if pool is not None:
                pool.shutdown(wait=False)

    def _image_hw(self, name: str, loader) -> tuple[int, int]:
        """(height, width) of an image another rank decodes."""
        if self.preload is not None and name in self.preload:
            return self.preload[name].shape[:2]
        if self.image_loader is not None:
            return np.asarray(loader(name)).shape[:2]
        from PIL import Image

        with Image.open(resolve_image_path(self.img_dir, name)) as im:
            w, h = im.size
        return h, w


def _skip_crop(hw: tuple[int, int], size: int,
               rng: np.random.Generator) -> None:
    """Advances ``rng`` as ``random_crop`` of an image of ``hw`` would."""
    h, w = max(hw[0], size), max(hw[1], size)
    rng.integers(0, h - size + 1)
    rng.integers(0, w - size + 1)
