"""Synthetic Market-1501-scale workload generator (the port's copy of
tpu_reid/tools/synth_market.py: from the same seed it writes the same
files).

Creates everything an end-to-end eval or training run needs, at real
Market-1501 scale, without downloading anything:

  * `Market1501/` directory tree in the reference's layout
    (bounding_box_train / query / bounding_box_test, filenames
    `{pid:04d}_c{cam}s{seq}_{frame:06d}_{idx:02d}.jpg` — reference parser:
    datasets/dataset_market.py:55-79),
  * a random ViT-B/16 checkpoint in OpenAI CLIP state-dict format
    (square 224-grid positional embedding; the converter bicubic-resizes
    it to the rectangular ReID grid, reference: coop.py:474-481),
  * a BPE merges file sized to the checkpoint's vocabulary,
  * `market_attribute.mat` covering every identity (27 attribute rows +
    image_index, reference: data_prepare.py:297-316).

Identity signal: images of one identity share a low-resolution random
pattern (upsampled, plus per-image noise/brightness/shift). A frozen
random encoder preserves input similarity, so retrieval mAP on this
workload is far above chance — which makes host-vs-device mAP deltas a
meaningful parity measurement (agreement at mAP≈0 or mAP=1 proves
nothing).

    python -m tpu_reid_torch.tools.synth_market --out /tmp/market_scale
    python -m tpu_reid_torch.tools.synth_market --out /tmp/market_small \
        --train_ids 20 --test_ids 20 --query 60 --gallery 300
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def _identity_pattern(
    rng: np.random.RandomState, hw, difficulty: float = 0.0
) -> np.ndarray:
    """Per-identity signature: low-res random palette, bilinear-upsampled.

    difficulty in [0, 1] contracts the pattern's dynamic range toward
    mid-gray, shrinking the identity signal relative to the (scaled-up)
    per-image noise in _render: at difficulty 0 every trained config
    saturates to Rank-1 = 1.0, and quality differences between modes do
    not show."""
    h, w = hw
    lo = rng.randint(0, 255, (8, 4, 3)).astype(np.float32)
    yi = np.linspace(0, 7, h)
    xi = np.linspace(0, 3, w)
    y0 = np.floor(yi).astype(int); y1 = np.minimum(y0 + 1, 7)
    x0 = np.floor(xi).astype(int); x1 = np.minimum(x0 + 1, 3)
    fy = (yi - y0)[:, None, None]; fx = (xi - x0)[None, :, None]
    top = lo[y0][:, x0] * (1 - fx) + lo[y0][:, x1] * fx
    bot = lo[y1][:, x0] * (1 - fx) + lo[y1][:, x1] * fx
    out = top * (1 - fy) + bot * fy
    if difficulty > 0:
        out = 128.0 + (out - 128.0) * (1.0 - 0.6 * float(difficulty))
    return out


def _render(rng, pattern, hw, difficulty: float = 0.0) -> np.ndarray:
    h, w = hw
    d = float(difficulty)
    img = pattern.copy()
    img += rng.normal(0, 28.0 + 70.0 * d, img.shape)   # per-image noise
    b = 18.0 + 30.0 * d
    img += rng.uniform(-b, b)                          # brightness jitter
    shift = rng.randint(-3 - int(5 * d), 4 + int(5 * d))
    img = np.roll(img, shift, axis=1)                  # small translation
    return np.clip(img, 0, 255).astype(np.uint8)


def write_images(base, rng, n_train_ids, n_test_ids, n_query, n_gallery,
                 hw, difficulty=0.0):
    from PIL import Image

    for sub in ("bounding_box_train", "query", "bounding_box_test"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)

    train_pids = list(range(1, n_train_ids + 1))
    test_pids = list(range(n_train_ids + 1, n_train_ids + n_test_ids + 1))
    patterns = {}

    def save(sub, pid, cam, frame, idx):
        if pid not in patterns:
            patterns[pid] = _identity_pattern(rng, hw, difficulty)
        img = _render(rng, patterns[pid], hw, difficulty)
        name = f"{pid:04d}_c{cam}s1_{frame:06d}_{idx:02d}.jpg"
        Image.fromarray(img).save(
            os.path.join(base, sub, name), quality=90
        )

    # train: ~17 images/id across 6 cams (real Market: 12936/751)
    n_total = 0
    for pid in train_pids:
        for k in range(17):
            save("bounding_box_train", pid, 1 + k % 6, k, 0)
            n_total += 1

    # query: round-robin over test ids; camera 1+i%3
    for i in range(n_query):
        pid = test_pids[i % n_test_ids]
        save("query", pid, 1 + (i // n_test_ids) % 3, i, 0)

    # gallery: every id appears on cameras OTHER than some query cams too
    # (cross-camera protocol needs same-id/different-cam matches)
    for i in range(n_gallery):
        pid = test_pids[i % n_test_ids]
        save("bounding_box_test", pid, 1 + (i // n_test_ids) % 6, i, 1)

    return n_total


def write_images_duke(base, rng, n_train_ids, n_test_ids, n_query, n_gallery,
                      hw, difficulty=0.0):
    """DukeMTMC-reID layout: `{pid:04d}_c{cam}_f{frame:07d}.jpg`, cams 1..8
    (reference parser: datasets/dataset_dukemtmc.py:66-85)."""
    from PIL import Image

    for sub in ("bounding_box_train", "query", "bounding_box_test"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)

    train_pids = list(range(1, n_train_ids + 1))
    test_pids = list(range(n_train_ids + 1, n_train_ids + n_test_ids + 1))
    patterns = {}

    def save(sub, pid, cam, frame):
        if pid not in patterns:
            patterns[pid] = _identity_pattern(rng, hw, difficulty)
        img = _render(rng, patterns[pid], hw, difficulty)
        name = f"{pid:04d}_c{cam}_f{frame:07d}.jpg"
        Image.fromarray(img).save(os.path.join(base, sub, name), quality=90)

    n_total = 0
    # real Duke: 16522 train / 702 ids ~ 23 imgs/id over 8 cams
    for pid in train_pids:
        for k in range(23):
            save("bounding_box_train", pid, 1 + k % 8, k)
            n_total += 1
    for i in range(n_query):
        pid = test_pids[i % n_test_ids]
        save("query", pid, 1 + (i // n_test_ids) % 4, i)
    for i in range(n_gallery):
        pid = test_pids[i % n_test_ids]
        save("bounding_box_test", pid, 1 + (i // n_test_ids) % 8, 10000 + i)
    return n_total


VERI_TYPES = ["sedan", "suv", "van", "hatchback", "mpv", "pickup", "bus",
              "truck", "estate"]


def write_images_veri(out_base, rng, n_train_ids, n_test_ids, n_query,
                      n_gallery, hw, difficulty=0.0):
    """VeRi-776 layout: `image_train/image_query/image_test` with
    `{pid:04d}_c{cam:03d}_{frame:08d}_0.jpg` names, keypoint viewpoint
    files, gb2312 label XMLs with per-image typeID, and `list_type.txt`
    (reference parser: datasets/dataset_veri.py:34-72,131-137; pid<=776,
    cams 1..20)."""
    from PIL import Image

    assert n_train_ids + n_test_ids <= 776, "VeRi pids must stay <= 776"
    for sub in ("image_train", "image_query", "image_test"):
        os.makedirs(os.path.join(out_base, sub), exist_ok=True)

    train_pids = list(range(1, n_train_ids + 1))
    test_pids = list(range(n_train_ids + 1, n_train_ids + n_test_ids + 1))
    patterns = {}
    # fixed per-identity car type + viewpoint stream
    pid_type = {p: 1 + rng.randint(0, len(VERI_TYPES))
                for p in train_pids + test_pids}
    keypoints = {"train": [], "test": []}
    labels = {"train": [], "test": []}

    def save(sub, split, pid, cam, frame):
        if pid not in patterns:
            patterns[pid] = _identity_pattern(rng, hw, difficulty)
        img = _render(rng, patterns[pid], hw, difficulty)
        name = f"{pid:04d}_c{cam:03d}_{frame:08d}_0.jpg"
        Image.fromarray(img).save(
            os.path.join(out_base, sub, name), quality=90
        )
        keypoints[split].append(f"{sub}/{name} {rng.randint(0, 8)}")
        labels[split].append((name, pid_type[pid]))
        return name

    n_total = 0
    # real VeRi: 37,778 train / 576 ids (~65/id) over 20 cams
    per_id = 30
    for pid in train_pids:
        for k in range(per_id):
            save("image_train", "train", pid, 1 + k % 20, k)
            n_total += 1
    for i in range(n_query):
        pid = test_pids[i % n_test_ids]
        save("image_query", "test", pid, 1 + (i // n_test_ids) % 10, i)
    for i in range(n_gallery):
        pid = test_pids[i % n_test_ids]
        save("image_test", "test", pid, 1 + (i // n_test_ids) % 20, 10000 + i)

    for split in ("train", "test"):
        with open(os.path.join(out_base, f"keypoint_{split}.txt"), "w") as f:
            f.write("\n".join(keypoints[split]) + "\n")
        items = "\n".join(
            f'  <Item imageName="{name}" vehicleID="{name[:4]}" '
            f'cameraID="{name[5:9]}" colorID="1" typeID="{tid}"/>'
            for name, tid in labels[split]
        )
        xml = ('<?xml version="1.0" encoding="gb2312"?>\n<TrainingImages>\n'
               f"<Items>\n{items}\n</Items>\n</TrainingImages>\n")
        with open(os.path.join(out_base, f"{split}_label.xml"), "wb") as f:
            f.write(xml.encode("gb2312"))
    with open(os.path.join(out_base, "list_type.txt"), "w") as f:
        for i, t in enumerate(VERI_TYPES, start=1):
            f.write(f"{i} {t}\n")
    return n_total


def write_images_msmt(out_base, rng, n_train_ids, n_test_ids, n_query,
                      n_gallery, hw, difficulty=0.0):
    """MSMT17 V2 layout: `mask_train_v2`/`mask_test_v2` image trees plus
    list files (`list_train/val/query/gallery.txt`) with lines
    `<rel> <pid>`; camid parses from the 3rd underscore field, 1-based
    (reference parser: datasets/dataset_msmt17.py:63-80; train pids must
    be contiguous 0..N-1)."""
    from PIL import Image

    train_dir = os.path.join(out_base, "mask_train_v2")
    test_dir = os.path.join(out_base, "mask_test_v2")
    patterns = {}
    lists = {k: [] for k in ("train", "val", "query", "gallery")}

    def save(root, list_name, pid, cam, frame):
        key = (root, pid)
        if key not in patterns:
            patterns[key] = _identity_pattern(rng, hw, difficulty)
        sub = f"{pid:04d}"
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        rel = f"{sub}/{pid:04d}_{frame:03d}_{cam:02d}_x.jpg"
        img = _render(rng, patterns[key], hw, difficulty)
        Image.fromarray(img).save(os.path.join(root, rel), quality=90)
        lists[list_name].append(f"{rel} {pid}")

    n_total = 0
    # train pids 0..n-1 (parser asserts contiguity); ~90% train / 10% val
    for pid in range(n_train_ids):
        for k in range(10):
            save(train_dir, "train" if k else "val", pid, 1 + k % 15, k)
            n_total += 1
    for i in range(n_query):
        pid = i % n_test_ids
        save(test_dir, "query", pid, 1 + (i // n_test_ids) % 5, i)
    for i in range(n_gallery):
        pid = i % n_test_ids
        # gallery cams overlap the query cams so the cross-camera
        # filtering protocol actually removes same-pid/same-cam entries
        save(test_dir, "gallery", pid, 1 + (i // n_test_ids) % 15, 10000 + i)

    for name, rows in lists.items():
        with open(os.path.join(out_base, f"list_{name}.txt"), "w") as f:
            f.write("\n".join(rows) + "\n")
    return n_total


def write_images_vehicleid(out_base, rng, n_train_ids, n_test_ids, n_query,
                           n_gallery, hw, difficulty=0.0):
    """VehicleID_V1.0 layout: flat `image/` dir + `train_test_split` list
    files with `<name> <pid>` lines (reference parser:
    datasets/dataset_vehicleid.py:100-153). The protocol derives query and
    gallery from the test list itself — ONE random image per test id goes
    to the gallery, the rest become queries — so `n_gallery` is implied by
    `n_test_ids` and `n_query` sets the test-list density. All three
    official list sizes (800/1600/2400) are written with the same ids so
    any --test_size choice parses."""
    from PIL import Image

    img_dir = os.path.join(out_base, "image")
    split_dir = os.path.join(out_base, "train_test_split")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(split_dir, exist_ok=True)
    patterns = {}
    counter = [0]

    def save(pid):
        if pid not in patterns:
            patterns[pid] = _identity_pattern(rng, hw, difficulty)
        img = _render(rng, patterns[pid], hw, difficulty)
        name = f"{counter[0]:07d}"
        counter[0] += 1
        Image.fromarray(img).save(
            os.path.join(img_dir, name + ".jpg"), quality=90
        )
        return name

    n_total = 0
    train_lines = []
    # real VehicleID: ~8.6 images/vehicle in train
    for pid in range(1, n_train_ids + 1):
        for _ in range(9):
            train_lines.append(f"{save(pid)} {pid}")
            n_total += 1

    per_test = max(2, -(-n_query // n_test_ids) + 1)
    test_lines = []
    for pid in range(n_train_ids + 1, n_train_ids + n_test_ids + 1):
        for _ in range(per_test):
            test_lines.append(f"{save(pid)} {pid}")

    with open(os.path.join(split_dir, "train_list.txt"), "w") as f:
        f.write("\n".join(train_lines) + "\n")
    for size in (800, 1600, 2400):
        with open(os.path.join(split_dir, f"test_list_{size}.txt"), "w") as f:
            f.write("\n".join(test_lines) + "\n")
    print(f"vehicleid protocol: {n_test_ids * (per_test - 1)} query / "
          f"{n_test_ids} gallery (1 random image per test id)")
    return n_total


def write_images_personx(out_base, rng, n_train_ids, n_test_ids, n_query,
                         n_gallery, hw, difficulty=0.0):
    """PersonX_v1 layout: the three rendered-view subsets `4/ 5/ 6/`, each
    holding market-style bounding_box_train / query / bounding_box_test
    dirs with `{pid}_c{cam}...` names (reference parser:
    datasets/dataset_personx.py:14-43 globs all three subsets)."""
    from PIL import Image

    subs = ["4", "5", "6"]
    for s in subs:
        for d in ("bounding_box_train", "query", "bounding_box_test"):
            os.makedirs(os.path.join(out_base, s, d), exist_ok=True)

    train_pids = list(range(1, n_train_ids + 1))
    test_pids = list(range(n_train_ids + 1, n_train_ids + n_test_ids + 1))
    patterns = {}

    def save(sub, d, pid, cam, frame):
        if pid not in patterns:
            patterns[pid] = _identity_pattern(rng, hw, difficulty)
        img = _render(rng, patterns[pid], hw, difficulty)
        name = f"{pid:04d}_c{cam}s1_{frame:06d}_00.jpg"
        Image.fromarray(img).save(
            os.path.join(out_base, sub, d, name), quality=90
        )

    n_total = 0
    # real PersonX: ~12 images/id spread over the view subsets, 6 cams
    for pid in train_pids:
        for k in range(12):
            save(subs[k % 3], "bounding_box_train", pid, 1 + k % 6, k)
            n_total += 1
    for i in range(n_query):
        pid = test_pids[i % n_test_ids]
        save(subs[i % 3], "query", pid, 1 + (i // n_test_ids) % 3, i)
    for i in range(n_gallery):
        pid = test_pids[i % n_test_ids]
        save(subs[i % 3], "bounding_box_test", pid,
             1 + (i // n_test_ids) % 6, 10000 + i)
    return n_total


def write_attributes(path, n_ids_total):
    """27-row market_attribute.mat over identities 0001..{n}."""
    from scipy import io as sio

    rng = np.random.RandomState(7)
    n = n_ids_total
    rows = {}
    names10 = ["age", "backpack", "bag", "handbag", "clothes", "down", "up",
               "hair", "hat", "gender"]
    for j, nm in enumerate(names10):
        hi = 4 if nm == "age" else 2
        rows[nm] = [rng.randint(1, hi + 1, n).tolist()]
    for c in range(8):
        rows[f"up{c}"] = [rng.randint(1, 3, n).tolist()]
    for c in range(9):
        rows[f"down{c}"] = [rng.randint(1, 3, n).tolist()]
    idx_cell = np.empty((1, n), object)
    for j in range(n):
        idx_cell[0, j] = np.array([f"{j + 1:04d}"])
    rows["image_index"] = [idx_cell]
    split = np.array([tuple(rows[k] for k in rows)],
                     dtype=[(k, object) for k in rows])
    mat = np.array([[(split,)]], dtype=[("train", object)])
    sio.savemat(path, {"market_attribute": mat})


def make_vit_b16_state_dict(rng: np.random.RandomState, vocab: int) -> dict:
    """Random full-size ViT-B/16 CLIP state dict, OpenAI key layout
    (reference shape contract: coop.py:441-466)."""
    sd = {}
    vw, vl, tw, tl, emb, grid, ctx = 768, 12, 512, 12, 512, 14, 77

    def blocks(prefix, width, layers):
        s = width ** -0.5
        for i in range(layers):
            pre = f"{prefix}.{i}"
            sd[f"{pre}.attn.in_proj_weight"] = rng.randn(3 * width, width) * s
            sd[f"{pre}.attn.in_proj_bias"] = np.zeros(3 * width)
            sd[f"{pre}.attn.out_proj.weight"] = rng.randn(width, width) * s * 0.5
            sd[f"{pre}.attn.out_proj.bias"] = np.zeros(width)
            sd[f"{pre}.ln_1.weight"] = np.ones(width)
            sd[f"{pre}.ln_1.bias"] = np.zeros(width)
            sd[f"{pre}.ln_2.weight"] = np.ones(width)
            sd[f"{pre}.ln_2.bias"] = np.zeros(width)
            sd[f"{pre}.mlp.c_fc.weight"] = rng.randn(4 * width, width) * s * 0.7
            sd[f"{pre}.mlp.c_fc.bias"] = np.zeros(4 * width)
            sd[f"{pre}.mlp.c_proj.weight"] = rng.randn(width, 4 * width) * s * 0.35
            sd[f"{pre}.mlp.c_proj.bias"] = np.zeros(width)

    s = vw ** -0.5
    sd["visual.conv1.weight"] = rng.randn(vw, 3, 16, 16) * s
    sd["visual.class_embedding"] = rng.randn(vw) * s
    sd["visual.positional_embedding"] = rng.randn(grid * grid + 1, vw) * s
    sd["visual.ln_pre.weight"] = np.ones(vw)
    sd["visual.ln_pre.bias"] = np.zeros(vw)
    blocks("visual.transformer.resblocks", vw, vl)
    sd["visual.ln_post.weight"] = np.ones(vw)
    sd["visual.ln_post.bias"] = np.zeros(vw)
    sd["visual.proj"] = rng.randn(vw, emb) * s

    sd["token_embedding.weight"] = rng.randn(vocab, tw) * 0.02
    sd["positional_embedding"] = rng.randn(ctx, tw) * 0.01
    blocks("transformer.resblocks", tw, tl)
    sd["ln_final.weight"] = np.ones(tw)
    sd["ln_final.bias"] = np.zeros(tw)
    sd["text_projection"] = rng.randn(tw, emb) * tw ** -0.5
    sd["logit_scale"] = np.asarray(np.log(1 / 0.07))
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--train_ids", type=int, default=751)
    p.add_argument("--test_ids", type=int, default=750)
    p.add_argument("--query", type=int, default=3368)
    p.add_argument("--gallery", type=int, default=15913)
    p.add_argument("--hw", type=int, nargs=2, default=(128, 64))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--difficulty", type=float, default=0.0,
                   help="0..1: identity-signal SNR knob (0 = legacy easy "
                        "workload; ~0.7 keeps trained Rank-1 below 1.0 so "
                        "inter-mode deltas are measurable)")
    p.add_argument("--skip_checkpoint", action="store_true")
    p.add_argument("--dataset", default="market1501",
                   choices=["market1501", "dukemtmc", "veri", "msmt17",
                            "vehicleid", "personx"],
                   help="directory layout + filename scheme to emit")
    args = p.parse_args(argv)

    rng = np.random.RandomState(args.seed)
    if args.dataset == "vehicleid":
        base = os.path.join(args.out, "VehicleID_V1.0")
        n_train = write_images_vehicleid(
            base, rng, args.train_ids, args.test_ids, args.query,
            args.gallery, tuple(args.hw), difficulty=args.difficulty,
        )
    elif args.dataset == "personx":
        base = os.path.join(args.out, "PersonX_v1")
        n_train = write_images_personx(
            base, rng, args.train_ids, args.test_ids, args.query,
            args.gallery, tuple(args.hw), difficulty=args.difficulty,
        )
    elif args.dataset == "msmt17":
        base = os.path.join(args.out, "MSMT17_V2")
        n_train = write_images_msmt(
            base, rng, args.train_ids, args.test_ids, args.query,
            args.gallery, tuple(args.hw), difficulty=args.difficulty,
        )
    elif args.dataset == "veri":
        base = os.path.join(args.out, "VeRi")
        n_train = write_images_veri(
            base, rng, args.train_ids, args.test_ids, args.query,
            args.gallery, tuple(args.hw), difficulty=args.difficulty,
        )
    elif args.dataset == "dukemtmc":
        base = os.path.join(args.out, "DukeMTMC-reID")
        n_train = write_images_duke(
            base, rng, args.train_ids, args.test_ids, args.query,
            args.gallery, tuple(args.hw), difficulty=args.difficulty,
        )
    else:
        base = os.path.join(args.out, "Market1501")
        n_train = write_images(
            base, rng, args.train_ids, args.test_ids, args.query,
            args.gallery, tuple(args.hw), difficulty=args.difficulty,
        )
    print(f"images: {n_train} train / {args.query} query / "
          f"{args.gallery} gallery under {base}")

    write_attributes(
        os.path.join(args.out, "market_attribute.mat"),
        args.train_ids + args.test_ids,
    )

    from tpu_reid_torch.models.tokenizer import write_test_merges

    merges = [("p", "h"), ("ph", "o"), ("o", "f</w>"), ("t", "h"),
              ("th", "e</w>"), ("a", "n"), ("an", "d</w>")]
    write_test_merges(os.path.join(args.out, "merges.txt.gz"), merges)
    vocab = 2 * 256 + len(merges) + 2

    if not args.skip_checkpoint:
        import torch

        sd = make_vit_b16_state_dict(np.random.RandomState(args.seed + 1),
                                     vocab)
        torch.save(
            {k: torch.from_numpy(v) for k, v in sd.items()},
            os.path.join(args.out, "vit_b16_random.pth"),
        )
        print(f"checkpoint: vit_b16_random.pth (vocab {vocab})")
    print("DONE")


if __name__ == "__main__":
    main()
