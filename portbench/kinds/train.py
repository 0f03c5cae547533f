"""Stage-2 training on the host loop, as the prompt-learning CLI runs it
without --cache_device: `train/trainer.run_stage2` over PK batches (ID,
triplet and image-to-text losses, Adam, the BNNeck statistics as state).

One call of run_stage2 holds the set-up and the window, so the same
training object runs both: epochs 0 to setup_steps-1 are one step each on
distinct batches (they build and warm every shape; their lr is the
schedule's), and the next epoch is the window, batches until `seconds`
have passed. The e2e metric is the window's time over the steps it
completed. The set-up steps are what the check compares: each step's loss,
the first gradient as Adam takes it (read back from its first moment), the
trained leaves and the BNNeck statistics after the last set-up step,
against the plain reference's steps from the same weights and batches.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from portbench import data as D
from portbench import harness as H
from portbench.trace import TRIES

DTYPES = {"fp32": torch.float32}
SPAN = "bench.run_stage2"
GRAD_FLOOR = 1e-3  # slices whose reference gradient is below this share of the median


class LossRecorder:
    """The training loop's guard interface, recording each step's loss in
    order and never rolling back (the CLI's guard would put a host copy of
    the whole state into the window every 50 steps)."""

    def __init__(self):
        self.losses = []

    def will_snapshot(self, step: int) -> bool:
        return False

    def maybe_snapshot(self, step: int, *state) -> None:
        pass

    def check(self, loss, *state):
        self.losses.append(float(loss))
        return state, True


def flat(tree, prefix=""):
    """{"/"-joined path: tensor} of a nested dict."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flat(v, name))
        elif isinstance(v, torch.Tensor):
            out[name] = v
    return out


def slices(name: str, t: torch.Tensor) -> dict:
    """A leaf cut into the pieces the check compares: one per layer of a
    stacked block leaf, and the fused qkv projection into q, k and v."""
    parts = {name: t}
    if "/blocks/" in name:
        parts = {f"{name}/{i}": t[i] for i in range(t.shape[0])}
    if "/in_proj/" in name:
        parts = {f"{k}/{q}": c for k, v in parts.items()
                 for q, c in zip("qkv", v.chunk(3, dim=-1))}
    return parts


class Run:
    def __init__(self, cell: H.Cell, seed: int, device: torch.device, clock: H.SetupClock):
        self.cfg, self.tr = cell.config, cell.traffic
        self.seed, self.dev, self.clock = seed, device, clock
        self.ref = H.config_module(self.cfg, "reference")
        self.prog = H.config_module(self.cfg, "program")
        self.failed = 0
        self.attempted = 0

    def _pool(self):
        """pool_batches PK batches: (normalized images (B, H, W, 3), labels)."""
        tr, cfg = self.tr, self.cfg
        gen = torch.Generator(device=self.dev).manual_seed(self.seed + 1)
        out = []
        for _ in range(tr["pool_batches"]):
            labels = D.pk_labels(gen, cfg["n_cls"], tr["p_ids"], tr["k_images"], self.dev)
            images = D.identity_images(gen, labels, cfg["image_hw"], cfg["n_cls"])
            out.append((self.ref.normalize(cfg, images), labels))
        return out

    def execute(self, seconds: float, tracer=None) -> dict:
        from tpu_reid_torch.device import full_fp32_convs
        from tpu_reid_torch.train import trainer as TR

        cfg, tr, dev = self.cfg, self.tr, self.dev
        full_fp32_convs()
        self.raw = H.make_raw(self.ref.param_spec(cfg, ["visual", "text", "head"]), self.seed,
                              dev, DTYPES[tr["dtype"]])
        params = self.prog.params(self.raw, cfg)
        mcfg = self.prog.model_config(cfg)
        self.clock.mark("weights")
        self.pool = self._pool()
        valid = torch.ones(tr["batch"], dtype=torch.bool, device=dev)
        self.clock.mark("data")
        tcfg = TR.TrainConfig(lr_stage2=tr["lr"], weight_decay=tr["weight_decay"],
                              triplet_margin=tr["triplet_margin"],
                              id_loss_weight=tr["id_loss_weight"],
                              label_smooth_eps=tr["label_smooth"])
        n_setup = tr["setup_steps"]
        guard = LossRecorder()
        st = {"steps": 0, "trace": None}
        # traced: an epoch of trace_steps per try, until one trace is whole
        epochs = n_setup + (TRIES if tracer is not None else 1)

        def batch(i):
            images, labels = self.pool[i % len(self.pool)]
            return images, labels, valid

        def epoch_batches(epoch):
            if epoch < n_setup:
                yield batch(epoch)
                return
            i = n_setup
            if tracer is not None:
                if st["trace"] is not None:
                    return
                for _ in range(tr["trace_steps"]):
                    st["steps"] += 1
                    yield batch(i)
                    i += 1
                return
            while time.perf_counter() < st["deadline"]:
                st["steps"] += 1
                yield batch(i)
                i += 1

        def on_epoch(epoch, p, extra):
            if epoch == 0:
                self._sync()
                # the stage's text features, the first step's first calls
                self.clock.mark("first_step")
                opt = extra["optimizer"]["state"]
                b1 = tr["betas"][0]
                # Adam's first moment after one step is (1 - beta1) x the gradient
                self.grad1 = {path: opt[i]["exp_avg"].detach() / (1 - b1)
                              for i, path in enumerate(extra["opt_paths"])}
            if epoch == n_setup - 1:
                leaves = flat(p)
                self.after = {k: v.detach().clone() for k, v in leaves.items()
                              if self.ref.stage2_trainable(k)
                              or (k.startswith("head/bn") and k.endswith(("mean", "var")))}
                self.setup_losses = list(guard.losses)
                self._sync()
                self.clock.mark("setup_steps")
                st["t0"] = time.perf_counter()
                st["deadline"] = st["t0"] + seconds
                if tracer is not None:
                    tracer.start()
            if epoch >= n_setup and tracer is not None and st["trace"] is None:
                self._sync()
                tracer.stop()
                data = tracer.reduce()
                if data.complete or epoch == epochs - 1:
                    st["trace"] = data
                else:
                    st["steps"] = 0
                    tracer.start()
            elif epoch == n_setup:
                self._sync()
                st["t1"] = time.perf_counter()

        TR.run_stage2(params, mcfg, tcfg, epoch_batches, epochs=epochs,
                      log=lambda s: print(s, file=sys.stderr), checkpoint_cb=on_epoch,
                      guard=guard)
        self.window_losses = guard.losses[n_setup:]
        self.attempted = st["steps"]
        self.failed = int(sum(not np.isfinite(v) for v in self.window_losses))
        if tracer is not None:
            return {"work": {"steps": st["steps"], "batch": tr["batch"]}, "trace": st["trace"]}
        return {"e2e": {"step_ms": 1e3 * (st["t1"] - st["t0"]) / max(st["steps"], 1)}}

    def _sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    # -- correctness -------------------------------------------------------

    def readings(self) -> dict:
        return {"losses": self.setup_losses,
                "grad1": self.grad1,
                "params": {k: v for k, v in self.after.items() if self.ref.stage2_trainable(k)},
                "bn": {k: v for k, v in self.after.items() if k.startswith("head/bn")}}

    def free_program(self) -> None:
        """The program's state went with run_stage2's return; only the
        readings copied out of it stay."""
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str) -> dict:
        n = self.tr["setup_steps"]
        return self.ref.stage2_steps(self.ref.Precision(precision), self.raw, self.cfg, self.tr,
                                     self.pool[:n], list(range(n)))

    def compare(self, got: dict, want: dict) -> dict:
        """Each number is a gap of norms, worst over the pieces, against the
        reference's norm of the piece or of the median piece, whichever is
        larger; pieces whose reference gradient is below GRAD_FLOOR of the
        median piece's move under Adam by round-off alone and are left
        out (of the gradient's and of the change's comparison)."""
        inf = float("inf")
        lw, lg = want["losses"], got["losses"]
        if len(lg) != len(lw) or not np.all(np.isfinite(lg)):
            loss_gap = inf
        else:
            loss_gap = max(abs(a - b) / abs(b) for a, b in zip(lg, lw))
        if set(got["grad1"]) != set(want["grad1"]):
            # the program trains other leaves than the configuration states
            return {"loss_rel_gap": loss_gap, "grad_norm_gap": inf, "delta_norm_gap": inf,
                    "bn_stat_gap": inf}
        g_ref, g_got, d_ref, d_got = {}, {}, {}, {}
        for name, g in want["grad1"].items():
            g_ref.update(slices(name, g))
            g_got.update(slices(name, got["grad1"].get(name, torch.zeros_like(g))))
            p0 = self.raw[name].float()
            d_ref.update(slices(name, want["params"][name] - p0))
            d_got.update(slices(name, got["params"].get(name, p0) - p0))
        norm = lambda t: float(t.float().norm())  # noqa: E731
        gr = {k: norm(v) for k, v in g_ref.items()}
        med = float(np.median(list(gr.values())))
        kept = [k for k, v in gr.items() if v >= GRAD_FLOOR * med]
        self.left_out = sorted(set(gr) - set(kept))

        def worst(ref: dict, got_: dict) -> float:
            rn = {k: norm(ref[k]) for k in kept}
            m = float(np.median(list(rn.values())))
            gaps = [abs(norm(got_[k]) - rn[k]) / max(rn[k], m) for k in kept]
            return max(gaps) if np.all(np.isfinite(gaps)) else inf

        bn = []
        for k, w in want["bn"].items():
            moved = norm(w - self.raw[k].float())
            bn.append(norm(got["bn"][k].float() - w) / max(moved, 1e-30))
        return {"loss_rel_gap": loss_gap,
                "grad_norm_gap": worst(g_ref, g_got),
                "delta_norm_gap": worst(d_ref, d_got),
                "bn_stat_gap": max(bn) if np.all(np.isfinite(bn)) else inf}
