"""Caption-prompt generator: offline renderers + a VLM-API captioner (the
port's copy of tpu_reid/tools/caption_prompts.py).

Produces the `"label: description"` per-identity prompt files consumed by
the caption prompt learner (models/prompts.read_caption_prompts, the
prompt-learning CLI's --captions_file), playing
the role of the reference's GPT-4o captioning script
(reference: prompt_generator.py:31-96; README.md:17 notes the resulting
prompts were never shipped).

Three sources:
  * --attributes market_attribute.mat — renders the deterministic
    attribute sentences (same text as the zero-shot prompts),
  * --generic — "person no.{i}" placeholder captions,
  * --api_url + --images_root — an OpenAI-compatible chat-completions
    captioner (reference behavior: 2 random crops per identity, refusal
    retry with crop resampling, model escalation after 2 refusals,
    transient-error retry with backoff). Stdlib urllib only; this is the
    one component that talks to a network service, so the offline
    renderers stay the default.

    python -m tpu_reid_torch.tools.caption_prompts --n_cls 751 \
        --attributes market_attribute.mat --out prompts_market1501.txt

    python -m tpu_reid_torch.tools.caption_prompts --n_cls 751 \
        --images_root Market1501/bounding_box_train \
        --api_url https://api.openai.com/v1/chat/completions \
        --api_key $KEY --out prompts_market1501.txt
"""

from __future__ import annotations

import argparse
import base64
import glob
import json
import os
import random
import time
import urllib.request
from collections import defaultdict

# The reference's captioning instruction (prompt_generator.py:60) — the
# produced captions feed read_caption_prompts, so the instruction text is
# part of the data contract, kept verbatim.
CAPTION_INSTRUCTION = (
    "Focus on the person in the photos. Summarize the common parts of the "
    "person's clothing and exclude behavior in one sentence starting with "
    "'A photo of a'."
)

REFUSAL_MARKERS = ("sorry", "unable")


def collect_identity_images(images_root: str) -> dict[int, list[str]]:
    """Market-style crops `<label>_*.jpg` grouped by identity label
    (reference: prompt_generator.py:20-28; junk labels < 0 skipped)."""
    by_label: dict[int, list[str]] = defaultdict(list)
    for path in sorted(glob.glob(os.path.join(images_root, "*.jpg"))):
        name = os.path.basename(path)
        try:
            label = int(name.split("_")[0])
        except ValueError:
            continue
        if label >= 0:
            by_label[label].append(path)
    return dict(by_label)


def _b64(path: str) -> str:
    with open(path, "rb") as f:
        return base64.b64encode(f.read()).decode("utf-8")


def _post_json(url: str, headers: dict, payload: dict, timeout: float):
    req = urllib.request.Request(
        url,
        data=json.dumps(payload).encode("utf-8"),
        headers={"Content-Type": "application/json", **headers},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode("utf-8"))


def caption_identity(
    crops: list[str],
    api_url: str,
    api_key: str,
    model: str = "gpt-4o-mini",
    escalate_model: str = "gpt-4o",
    escalate_after: int = 2,
    max_attempts: int = 8,
    rng: random.Random | None = None,
    post_fn=None,
    retry_sleep: float = 1.0,
) -> str:
    """One identity's caption via an OpenAI-compatible endpoint.

    Mirrors the reference loop (prompt_generator.py:31-96): sample 2 crops,
    send both images + the instruction, resample-and-retry while the reply
    contains a refusal marker, escalate to the stronger model after
    `escalate_after` refusals, retry transport/API errors with a pause.
    `max_attempts` bounds the reference's unbounded loop; `post_fn` is
    injectable for tests."""
    rng = rng or random.Random()
    post = post_fn or _post_json
    headers = {"Authorization": f"Bearer {api_key}"}
    content = ""
    for attempt in range(max_attempts):
        if attempt >= escalate_after:
            model = escalate_model
        pick = rng.sample(crops, 2) if len(crops) >= 2 else crops * 2
        payload = {
            "model": model,
            "messages": [{
                "role": "user",
                "content": [
                    {"type": "text", "text": CAPTION_INSTRUCTION},
                    *({"type": "image_url",
                       "image_url": {
                           "url": f"data:image/jpeg;base64,{_b64(p)}"}}
                      for p in pick),
                ],
            }],
            "max_tokens": 256,
        }
        try:
            res = post(api_url, headers, payload, 120.0)
        except Exception:
            time.sleep(retry_sleep)
            continue
        if "error" in res:
            time.sleep(retry_sleep)
            continue
        content = res["choices"][0]["message"]["content"].strip()
        if not any(m in content.lower() for m in REFUSAL_MARKERS):
            return content
    raise RuntimeError(
        f"captioner gave no usable answer in {max_attempts} attempts "
        f"(last: {content[:80]!r})"
    )


def caption_via_api(args) -> list[str]:
    by_label = collect_identity_images(args.images_root)
    if len(by_label) < args.n_cls:
        raise SystemExit(
            f"{args.images_root} holds {len(by_label)} identities, "
            f"need {args.n_cls}"
        )
    rng = random.Random(args.seed)
    lines = []
    for i, label in enumerate(sorted(by_label)[: args.n_cls]):
        text = caption_identity(
            by_label[label], args.api_url, args.api_key,
            model=args.model, escalate_model=args.escalate_model,
            rng=rng, retry_sleep=args.retry_sleep,
        )
        lines.append(f"{i}: {text}")
    return lines


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n_cls", required=True, type=int)
    p.add_argument("--attributes", default=None, type=str)
    p.add_argument("--out", required=True, type=str)
    p.add_argument("--images_root", default=None, type=str,
                   help="Market-style crop dir for the API captioner")
    p.add_argument("--api_url", default=None, type=str,
                   help="OpenAI-compatible /chat/completions endpoint")
    p.add_argument("--api_key", default=os.environ.get("OPENAI_API_KEY", ""))
    p.add_argument("--model", default="gpt-4o-mini")
    p.add_argument("--escalate_model", default="gpt-4o")
    p.add_argument("--retry_sleep", default=1.0, type=float)
    p.add_argument("--seed", default=0, type=int)
    args = p.parse_args(argv)

    if args.api_url:
        if not args.images_root:
            raise SystemExit("--api_url requires --images_root")
        lines = caption_via_api(args)
    elif args.attributes:
        from tpu_reid_torch.data.attributes import get_prompts

        ids, prompts = get_prompts(args.attributes)
        lines = [
            f"{i}: A photo of {prompts[ident].lstrip('a ')}"
            for i, ident in enumerate(ids[: args.n_cls])
        ]
        if len(lines) < args.n_cls:
            raise SystemExit(
                f"attribute file covers {len(lines)} identities, "
                f"need {args.n_cls}"
            )
    else:
        lines = [
            f"{i}: A photo of person no.{i}." for i in range(args.n_cls)
        ]

    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {len(lines)} caption prompts to {args.out}")


if __name__ == "__main__":
    main()
