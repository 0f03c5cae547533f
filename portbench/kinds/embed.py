"""Gallery embedding, as the prompt-learning CLI's test phase runs it:
uint8 crops on the host, one batch at a time through
`parallel/extract.extract_embeddings` over the program's `eval_embed`
(flip-TTA, the input normalisation folded into the patch embedding), in a
closed loop for the window. The e2e metric is the embeddings completed over
all the window's time.

Correctness: a sample of the window's embeddings, drawn from the seed,
against the plain reference's embeddings of the same crops under the same
weights (the relative L2 gap of each row, the worst row compared).
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench import data as D
from portbench import harness as H
from portbench.trace import TRIES

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
SPAN = "bench.extract_embeddings"
REF_ROWS = 64  # reference rows per block


class Run:
    def __init__(self, cell: H.Cell, seed: int, device: torch.device, clock: H.SetupClock):
        self.cfg, self.tr = cell.config, cell.traffic
        self.seed, self.dev, self.clock = seed, device, clock
        self.ref = H.config_module(self.cfg, "reference")
        self.prog = H.config_module(self.cfg, "program")
        self.batch = self.tr["batch"]
        self.failed = 0

    def execute(self, seconds: float, tracer=None) -> dict:
        """Set-up, then the timed window (or, with a tracer, the traced one):
        {"e2e": metrics} or {"work": what the readers count}."""
        self.setup()
        if tracer is not None:
            return {"work": self.traced(tracer), "trace": self.trace}
        return {"e2e": self.window(seconds)}

    # -- set-up ------------------------------------------------------------

    def setup(self) -> None:
        from tpu_reid_torch.data.transforms import DevicePreprocess
        from tpu_reid_torch.device import full_fp32_convs
        from tpu_reid_torch.models import reid_clip as M
        from tpu_reid_torch.ops.attention import set_fast_softmax
        from tpu_reid_torch.parallel.extract import make_extractor

        cfg, tr, dev = self.cfg, self.tr, self.dev
        full_fp32_convs()
        dtype = DTYPES[tr["dtype"]]
        self.raw = H.make_raw(self.ref.param_spec(cfg, ["visual"]), self.seed, dev, dtype)
        self.params = self.prog.params(self.raw, cfg)
        mcfg = self.prog.model_config(cfg)
        self.clock.mark("weights")
        self.pool = self._pool()
        self.clock.mark("data")
        set_fast_softmax(bool(tr["fast_softmax"]))
        fold = (lambda p: M.fold_input_norm(p, mcfg, "vit")) if tr["fold_input_norm"] else None
        self.extractor = make_extractor(
            lambda p, im: M.eval_embed(p, mcfg, im),
            DevicePreprocess(tuple(cfg["image_hw"]), "vit", dtype=dtype),
            flip_tta=bool(tr["flip_tta"]), dtype=dtype, fold=fold, device=dev)
        self._sweep(self._batches(range(tr["warmup_batches"])))
        self._sync()
        self.clock.mark("warmup")

    def _pool(self) -> np.ndarray:
        """The crops the window cycles through, (pool_batches, B, H, W, 3)
        uint8 on the host, as a decoded gallery would be."""
        gen = torch.Generator(device=self.dev).manual_seed(self.seed + 1)
        n = self.tr["pool_batches"] * self.batch
        ids = torch.randint(0, self.tr["identities"], (n,), generator=gen, device=self.dev)
        self.pool_ids = ids.cpu().numpy()
        images = D.identity_images(gen, ids, self.cfg["image_hw"], self.tr["identities"])
        return images.cpu().numpy().reshape(self.tr["pool_batches"], self.batch,
                                            *images.shape[1:])

    def _batch(self, i: int):
        k = i % self.pool.shape[0]
        b = self.batch
        return SimpleNamespace(images=self.pool[k], pids=self.pool_ids[k * b:(k + 1) * b],
                               camids=np.zeros(b, np.int64), seqids=np.zeros(b, np.int64),
                               valid=np.ones(b, bool))

    def _batches(self, indices):
        for i in indices:
            yield self._batch(i)

    def _sweep(self, batches) -> torch.Tensor:
        from tpu_reid_torch.parallel.extract import extract_embeddings

        return extract_embeddings(self.extractor, self.params, batches, device=self.dev)[0]

    def _sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    # -- the window --------------------------------------------------------

    def window(self, seconds: float) -> dict:
        """Batches until `seconds` have passed, then the last ones finish:
        the rate is over all the embeddings and all the time."""
        t0 = time.perf_counter()
        deadline = t0 + seconds

        def until():
            i = 0
            while time.perf_counter() < deadline:
                yield self._batch(i)
                i += 1

        self.feats = self._sweep(until())
        self._sync()
        elapsed = time.perf_counter() - t0
        self.attempted = int(self.feats.shape[0])
        self.failed = int((~torch.isfinite(self.feats).all(dim=1)).sum())
        return {"emb_per_s": self.attempted / elapsed}

    def traced(self, tracer) -> dict:
        """A fixed number of batches under the profiler, again while the
        trace comes back short; what the readers count."""
        n = self.tr["trace_batches"]
        for _ in range(TRIES):
            tracer.start()
            self.feats = self._sweep(self._batches(range(n)))
            tracer.stop()
            self.trace = tracer.reduce()
            if self.trace.complete:
                break
        self.attempted = int(self.feats.shape[0])
        self.failed = int((~torch.isfinite(self.feats).all(dim=1)).sum())
        return {"batches": n, "images": n * self.batch,
                "passes": 2 if self.tr["flip_tta"] else 1, "batch": self.batch}

    # -- correctness -------------------------------------------------------

    def readings(self) -> dict:
        """The sampled rows of the window's embeddings and their crops."""
        n = self.attempted
        rng = np.random.default_rng(self.seed + 2)
        rows = np.sort(rng.choice(n, size=min(self.tr["check_rows"], n), replace=False))
        b, k = self.batch, self.pool.shape[0]
        crops = self.pool[(rows // b) % k, rows % b]
        self.crops = torch.from_numpy(np.ascontiguousarray(crops)).to(self.dev)
        return {"emb": self.feats[torch.from_numpy(rows).to(self.feats.device)].float().clone()}

    def free_program(self) -> None:
        self.params = self.extractor = self.feats = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str) -> dict:
        P = self.ref.Precision(precision)
        out = []
        with P.scope(), torch.no_grad():
            for i in range(0, self.crops.shape[0], REF_ROWS):
                out.append(self.ref.eval_embeddings(P, self.raw, self.cfg,
                                                    self.crops[i:i + REF_ROWS],
                                                    bool(self.tr["flip_tta"])))
        return {"emb": torch.cat(out)}

    @staticmethod
    def compare(got: dict, want: dict) -> dict:
        g, w = got["emb"].float(), want["emb"].float()
        if g.shape != w.shape or not torch.isfinite(g).all():
            return {"emb_rel_err": float("inf")}
        rel = (g - w).norm(dim=1) / w.norm(dim=1).clamp_min(1e-30)
        return {"emb_rel_err": float(rel.max())}
