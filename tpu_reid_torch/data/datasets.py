"""Dataset parsers for the 7 ReID corpora (a copy of tpu_reid/data/datasets.py).

Each parser maps an on-disk layout to three lists of records
(img_path, pid, camid, seqid, idx) — the same 5-tuple contract as the
reference (reference: datasets/base_dataset.py:6-21) — with train pids
relabeled to a contiguous [0, n) range. Filename grammars mirrored:

  * Market-1501 — `{pid}_c{cam}s{seq}_...jpg`, junk pid=-1 skipped
    (reference: datasets/dataset_market.py:55-79)
  * DukeMTMC-reID — `{pid}_c{cam}_...jpg`, seqid always 0
    (reference: datasets/dataset_dukemtmc.py:66-85)
  * MSMT17 (V2) — list-file driven (`list_train/val/query/gallery.txt`,
    "relpath pid" lines, camid = 3rd `_` field), train+val merged
    (reference: datasets/dataset_msmt17.py:26-82)
  * MSMT17V1 — glob-driven like Market (reference: dataset_msmt17.py:85-154)
  * VeRi-776 — keypoint viewpoint files + car-type XML labels
    (reference: datasets/dataset_veri.py:34-178)
  * VehicleID — split lists; per-id one random gallery image, rest query,
    synthetic camids 0/1 (reference: datasets/dataset_vehicleid.py:95-155).
    The reference's gallery sampling uses the global `random` module —
    unseeded, so eval sets differ between runs (SURVEY.md §7); here the
    split takes an explicit seed (default 0) for reproducible evaluation.
  * PersonX — subdirs 4..6 each with the Market layout
    (reference: datasets/dataset_personx.py:21-82)

pid2label insertion order follows Python set iteration order in the
reference; we sort pids for determinism (a documented divergence — the
mapping is arbitrary either way, only contiguity matters).
"""

from __future__ import annotations

import dataclasses
import glob
import os.path as osp
import random
import re
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

Record = Tuple[str, int, int, int, int]  # (img_path, pid, camid, seqid, idx)


@dataclasses.dataclass
class ReidDataset:
    name: str
    train: List[Record]
    query: List[Record]
    gallery: List[Record]
    car_types_train: Optional[List[str]] = None  # VeRi only

    @property
    def num_train_pids(self) -> int:
        return len({r[1] for r in self.train})

    def stats(self) -> Dict[str, Tuple[int, int, int, int]]:
        def info(rows):
            return (
                len({r[1] for r in rows}),
                len(rows),
                len({r[2] for r in rows}),
                len({r[3] for r in rows}),
            )

        return {
            "train": info(self.train),
            "query": info(self.query),
            "gallery": info(self.gallery),
        }

    def describe(self) -> str:
        lines = [
            f"=> {self.name} loaded",
            "  subset   | # ids | # images | # cameras | # sequences",
        ]
        for split, (p, i, c, s) in self.stats().items():
            lines.append(f"  {split:<8} | {p:5d} | {i:8d} | {c:9d} | {s:9d}")
        return "\n".join(lines)


def _require(*paths: str) -> None:
    for p in paths:
        if not osp.exists(p):
            raise RuntimeError(f"'{p}' is not available")


def _glob_parse(
    dir_paths: Sequence[str],
    pattern: str,
    relabel: bool,
    *,
    with_seq: bool = False,
    cam_check: Optional[Callable[[int], bool]] = None,
    pid_check: Optional[Callable[[int], bool]] = None,
) -> List[Record]:
    rx = re.compile(pattern)
    img_paths: List[str] = []
    for d in dir_paths:
        img_paths.extend(sorted(glob.glob(osp.join(d, "*.jpg"))))
    pids = set()
    for p in img_paths:
        pid = int(rx.search(p).group(1))
        if pid != -1:
            pids.add(pid)
    pid2label = {pid: i for i, pid in enumerate(sorted(pids))}

    out: List[Record] = []
    for idx, p in enumerate(img_paths):
        groups = rx.search(p).groups()
        pid, camid = int(groups[0]), int(groups[1])
        if pid == -1:
            continue
        seqid = int(groups[2]) - 1 if with_seq else 0
        if pid_check is not None:
            assert pid_check(pid), f"pid {pid} out of range: {p}"
        if cam_check is not None:
            assert cam_check(camid), f"camid {camid} out of range: {p}"
        camid -= 1
        if relabel:
            pid = pid2label[pid]
        out.append((p, pid, camid, seqid, idx))
    return out


def load_market1501(root: str) -> ReidDataset:
    base = osp.join(root, "Market1501")
    dirs = {
        "train": osp.join(base, "bounding_box_train"),
        "query": osp.join(base, "query"),
        "gallery": osp.join(base, "bounding_box_test"),
    }
    _require(base, *dirs.values())
    pat = r"([-\d]+)_c(\d)s(\d)"

    def parse(d, relabel):
        return _glob_parse(
            [d], pat, relabel, with_seq=True,
            pid_check=lambda p: 0 <= p <= 1501,
            cam_check=lambda c: 1 <= c <= 6,
        )

    return ReidDataset(
        "market1501",
        parse(dirs["train"], True),
        parse(dirs["query"], False),
        parse(dirs["gallery"], False),
    )


def load_dukemtmc(root: str) -> ReidDataset:
    base = osp.join(root, "DukeMTMC-reID")
    dirs = [osp.join(base, d) for d in
            ("bounding_box_train", "query", "bounding_box_test")]
    _require(base, *dirs)
    pat = r"([-\d]+)_c(\d)"

    def parse(d, relabel):
        return _glob_parse([d], pat, relabel, cam_check=lambda c: 1 <= c <= 8)

    return ReidDataset(
        "dukemtmc", parse(dirs[0], True), parse(dirs[1], False),
        parse(dirs[2], False),
    )


def load_msmt17(root: str) -> ReidDataset:
    base = osp.join(root, "MSMT17_V2")
    train_dir = osp.join(base, "mask_train_v2")
    test_dir = osp.join(base, "mask_test_v2")
    _require(base, train_dir, test_dir)

    def parse(dir_path: str, list_name: str) -> List[Record]:
        rows = []
        with open(osp.join(base, list_name)) as f:
            for idx, line in enumerate(f):
                if not line.strip():
                    continue
                rel, pid = line.split(" ")
                pid = int(pid)
                camid = int(rel.split("_")[2]) - 1
                rows.append((osp.join(dir_path, rel), pid, camid, 0, idx))
        return rows

    train = parse(train_dir, "list_train.txt") + parse(train_dir, "list_val.txt")
    pids = sorted({r[1] for r in train})
    assert pids == list(range(len(pids))), "MSMT17 train pids not contiguous"
    return ReidDataset(
        "msmt17", train,
        parse(test_dir, "list_query.txt"),
        parse(test_dir, "list_gallery.txt"),
    )


def load_msmt17_v1(root: str) -> ReidDataset:
    base = osp.join(root, "MSMT17_V1")
    train_dir = osp.join(base, "bounding_box_train")
    test_dir = osp.join(base, "bounding_box_test")
    _require(base, train_dir, test_dir)
    pat = r"([-\d]+)_c(\d+)"

    def parse(d, relabel):
        return _glob_parse([d], pat, relabel, cam_check=lambda c: 1 <= c <= 15)

    # the reference evaluates V1 with query == gallery == bounding_box_test
    # (dataset_msmt17.py:110-112)
    return ReidDataset(
        "msmt17_v1", parse(train_dir, True), parse(test_dir, False),
        parse(test_dir, False),
    )


def load_personx(root: str) -> ReidDataset:
    base = osp.join(root, "PersonX_v1")
    subs = [str(i) for i in range(4, 7)]
    train_dirs = [osp.join(base, s, "bounding_box_train") for s in subs]
    query_dirs = [osp.join(base, s, "query") for s in subs]
    gallery_dirs = [osp.join(base, s, "bounding_box_test") for s in subs]
    _require(base, *train_dirs, *query_dirs, *gallery_dirs)
    pat = r"([-\d]+)_c([-\d]+)"
    return ReidDataset(
        "personx",
        _glob_parse(train_dirs, pat, True),
        _glob_parse(query_dirs, pat, False),
        _glob_parse(gallery_dirs, pat, False),
    )


# ---------------------------------------------------------------------------
# VeRi-776
# ---------------------------------------------------------------------------


def _read_keypoint_views(path: str) -> Dict[str, int]:
    views = {}
    with open(path) as f:
        for line in f:
            parts = line.split(" ")
            if len(parts) >= 2:
                views[osp.basename(parts[0])] = int(parts[-1])
    return views


def _read_type_xml(path: str) -> Dict[str, str]:
    """VeRi label XML: <Item imageName="..." typeID="..."/> elements. Parsed
    with a tolerant regex scan — the files are gb2312-encoded and not always
    well-formed enough for strict XML parsers."""
    with open(path, "rb") as f:
        raw = f.read()
    text = raw.decode("gb2312", errors="replace")
    out = {}
    for m in re.finditer(r"<Item\s+([^>/]*)/?>", text):
        attrs = dict(re.findall(r'(\w+)="([^"]*)"', m.group(1)))
        if "imageName" in attrs and "typeID" in attrs:
            out[attrs["imageName"]] = attrs["typeID"]
    return out


def load_veri(root: str) -> ReidDataset:
    base = osp.join(root, "VeRi")
    dirs = [osp.join(base, d) for d in ("image_train", "image_query", "image_test")]
    _require(base, *dirs)

    views = _read_keypoint_views(osp.join(base, "keypoint_train.txt"))
    views.update(_read_keypoint_views(osp.join(base, "keypoint_test.txt")))
    types = _read_type_xml(osp.join(base, "train_label.xml"))
    types.update(_read_type_xml(osp.join(base, "test_label.xml")))
    type_names = {}
    with open(osp.join(base, "list_type.txt")) as f:
        for line in f:
            parts = line.split(" ")
            if len(parts) >= 2:
                type_names[parts[0]] = parts[1].rstrip("\n")

    pat = re.compile(r"([-\d]+)_c(\d+)")

    def parse(d: str, relabel: bool) -> List[Record]:
        img_paths = sorted(glob.glob(osp.join(d, "*.jpg")))
        pids = {int(pat.search(p).group(1)) for p in img_paths}
        pids.discard(-1)
        pid2label = {pid: i for i, pid in enumerate(sorted(pids))}
        rows = []
        skipped = 0
        for idx, p in enumerate(img_paths):
            pid, camid = map(int, pat.search(p).groups())
            if pid == -1:
                continue
            assert 0 <= pid <= 776 and 1 <= camid <= 20
            name = osp.basename(p)
            if name not in views:
                skipped += 1  # images without viewpoint annotations dropped
                continue     # (reference: dataset_veri.py:131-137)
            rows.append(
                (p, pid2label[pid] if relabel else pid, camid - 1, views[name], idx)
            )
        return rows

    train = parse(dirs[0], True)
    # per-train-pid car type string for PromptLearnerVeri
    # (reference: dataset_veri.py:149-178)
    img_paths = sorted(glob.glob(osp.join(dirs[0], "*.jpg")))
    pids = sorted({int(pat.search(p).group(1)) for p in img_paths} - {-1})
    pid2label = {pid: i for i, pid in enumerate(pids)}
    car_types = ["" for _ in pids]
    for p in img_paths:
        pid = int(pat.search(p).group(1))
        if pid == -1:
            continue
        tid = types.get(osp.basename(p))
        if tid is not None and not car_types[pid2label[pid]]:
            car_types[pid2label[pid]] = type_names.get(tid, "")

    return ReidDataset(
        "veri", train, parse(dirs[1], False), parse(dirs[2], False),
        car_types_train=car_types,
    )


def load_vehicleid(root: str, test_size: int = 800, seed: int = 0) -> ReidDataset:
    base = osp.join(root, "VehicleID_V1.0")
    img_dir = osp.join(base, "image")
    split_dir = osp.join(base, "train_test_split")
    train_list = osp.join(split_dir, "train_list.txt")
    if test_size not in (800, 1600, 2400):
        raise RuntimeError(f'"{test_size}" is not available')
    test_list = osp.join(split_dir, f"test_list_{test_size}.txt")
    _require(base, split_dir, train_list, test_list)

    def read(path):
        d = defaultdict(list)
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                name, pid = line.split(" ")
                d[int(pid)].append(name)
        return d

    train_by_pid = read(train_list)
    test_by_pid = read(test_list)

    pid2label = {pid: i for i, pid in enumerate(sorted(train_by_pid))}
    train: List[Record] = []
    idx = 0
    for pid in sorted(train_by_pid):
        for name in train_by_pid[pid]:
            train.append(
                (osp.join(img_dir, name + ".jpg"), pid2label[pid], 0, 1, idx)
            )
            idx += 1

    rng = random.Random(seed)
    query: List[Record] = []
    gallery: List[Record] = []
    qi = gi = 0
    for pid in sorted(test_by_pid):
        names = list(test_by_pid[pid])
        pick = rng.choice(names)
        names.remove(pick)
        # gallery camid 1 / query camid 0 so cross-camera filtering keeps them
        # (reference: dataset_vehicleid.py:151-153)
        gallery.append((osp.join(img_dir, pick + ".jpg"), pid, 1, 1, gi))
        gi += 1
        for name in names:
            query.append((osp.join(img_dir, name + ".jpg"), pid, 0, 1, qi))
            qi += 1

    return ReidDataset("vehicleid", train, query, gallery)


_LOADERS = {
    "market1501": load_market1501,
    "dukemtmc": load_dukemtmc,
    "msmt17": load_msmt17,
    "msmt17_v1": load_msmt17_v1,
    "veri": load_veri,
    "vehicleid": load_vehicleid,
    "personx": load_personx,
}


def get_dataset(root: str, name: str, **kw) -> ReidDataset:
    """Name -> parser dispatch (reference: data_prepare.py:131-146)."""
    if name not in _LOADERS:
        raise NotImplementedError(name)
    return _LOADERS[name](root, **kw)


def merge_datasets(a: ReidDataset, b: ReidDataset) -> ReidDataset:
    """Concatenate two train sets with b's labels offset by a's pid count
    (reference: data_prepare.py:99-128)."""
    off = a.num_train_pids
    merged = list(a.train) + [
        (p, pid + off, cam, seq, idx) for (p, pid, cam, seq, idx) in b.train
    ]
    return ReidDataset(f"{a.name}+{b.name}", merged, [], [])
