"""Real-assets parity runbook (the port of
tpu_reid/tools/runbook_market_parity.py, without its downloads): run the
parity harness on Market-1501 with the OpenAI ViT-B/16 checkpoint and record
the result under a JSON file's ``published["market1501"]``.

The JAX runbook fetches the checkpoint, the CLIP BPE vocabulary and the
Market-1501 attribute annotations; this one fetches nothing. The user gives
them as paths, and a path that is missing raises naming it:

    python -m tpu_reid_torch.tools.runbook_market_parity --root /data/reid \\
        --model_path ViT-B-16.pt --bpe_path bpe_simple_vocab_16e6.txt.gz \\
        --attributes market_attribute.mat --baseline results.json

    # the same harness on a generated workload (nothing to give):
    python -m tpu_reid_torch.tools.runbook_market_parity --synthetic

What it does:
  1. checks the three files and ``<root>/Market1501`` (the dataset is
     distributed through per-user links and is never fetched; instructions
     print if it is missing),
  2. runs tools/parity_run: extracts features once through the port's
     zero-shot path, evaluates them through the port's tail and an
     independent numpy re-implementation of the reference's CMC/mAP math,
     checks their agreement and writes ``published["market1501"]``.
"""

from __future__ import annotations

import argparse
import os
import sys

from tpu_reid_torch.device import full_fp32_convs

MARKET_HELP = """\
Market-1501 not found at {path}.

The dataset is distributed through per-user links (no stable public URL):
  * request/download 'Market-1501-v15.09.15.zip' from the dataset page
    (Zheng et al., ICCV'15) or the academic mirrors linked from
    paperswithcode.com/dataset/market-1501,
  * unzip so that {path}/bounding_box_train, /query and
    /bounding_box_test exist (rename Market-1501-v15.09.15 -> Market1501
    or pass --root pointing at its parent).
Then re-run this command.
"""

# the files the JAX runbook downloads, given here as paths
ASSETS = (("model_path", "the OpenAI ViT-B/16 checkpoint (ViT-B-16.pt)"),
          ("bpe_path", "the CLIP BPE vocabulary (bpe_simple_vocab_16e6.txt.gz)"),
          ("attributes", "the Market-1501 attribute annotations (market_attribute.mat)"))


def main(argv=None):
    full_fp32_convs()
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--root", type=str, default=None, help="dataset root containing Market1501/")
    for name, what in ASSETS:
        p.add_argument(f"--{name}", type=str, default=None, help=what)
    p.add_argument("--baseline", type=str, default="BASELINE_torch.json",
                   help="JSON file to record the result in, under 'published'")
    p.add_argument("--bs", default=64, type=int)
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device: cuda (default) or cpu")
    p.add_argument("--synthetic", action="store_true",
                   help="the same harness on a generated Market-layout workload")
    args = p.parse_args(argv)

    from tpu_reid_torch.tools import parity_run

    if args.synthetic:  # the harness generates its own assets
        return parity_run.main(["--synthetic", "--baseline", args.baseline, "--device",
                                args.device])

    if not args.root:
        raise SystemExit("--root is required (or pass --synthetic)")
    missing = [f"--{name} ({what}): {getattr(args, name) or 'not given'}"
               for name, what in ASSETS
               if not getattr(args, name) or not os.path.isfile(getattr(args, name))]
    if missing:
        raise FileNotFoundError("the runbook downloads nothing; give these files as paths: "
                                + "; ".join(missing))

    market = os.path.join(args.root, "Market1501")
    if not os.path.isdir(os.path.join(market, "bounding_box_train")):
        sys.stderr.write(MARKET_HELP.format(path=market))
        return 2

    return parity_run.main([
        "--root", args.root, "--model_path", args.model_path, "--bpe_path", args.bpe_path,
        "--attributes", args.attributes, "--augmented_template",
        "--test_dataset", "market1501", "--bs", str(args.bs), "--height", "256",
        "--baseline", args.baseline, "--device", args.device,
    ])


if __name__ == "__main__":
    out = main()
    raise SystemExit(out if isinstance(out, int) else 0)
