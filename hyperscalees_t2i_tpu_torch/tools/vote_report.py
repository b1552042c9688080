"""Summarize the blind A/B votes that ``tools/demo.py`` records (port of
``hyperscalees_t2i_tpu/tools/vote_report.py``; pure Python, its output byte
for byte the reference's)::

    python -m hyperscalees_t2i_tpu_torch.tools.vote_report runs/x/votes.jsonl \\
        --out_json report.json --fitness_out fitness.jsonl

Overall LoRA winrate with an exact two-sided binomial sign-test p-value,
per-session and per-prompt breakdowns, and per-adapter fitness rows in the
trainer's reward-row shape.
"""

from __future__ import annotations

import argparse
import json
import math
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, List


def sign_test_p(wins: int, n: int) -> float:
    """Two-sided exact binomial p-value against p=0.5."""
    if n == 0:
        return 1.0
    tail = sum(math.comb(n, k) for k in range(0, min(wins, n - wins) + 1)) / 2**n
    return min(1.0, 2.0 * tail)


def load_votes(path: Path) -> List[Dict[str, Any]]:
    return [json.loads(l) for l in Path(path).read_text().splitlines() if l.strip()]


def report(votes: List[Dict[str, Any]]) -> Dict[str, Any]:
    unknown = [r for r in votes if r.get("winner") not in ("lora", "base")]
    if unknown:  # a skewed human-eval claim is worse than a loud one
        raise ValueError(
            f"{len(unknown)} vote records have winner outside "
            f"{{'lora','base'}} (e.g. {unknown[0]!r}); refusing to aggregate"
        )

    def bucket(rows):
        lw = sum(1 for r in rows if r["winner"] == "lora")
        n = len(rows)
        return {
            "n": n, "lora_wins": lw, "base_wins": n - lw,
            "lora_winrate": round(lw / n, 4) if n else None,
            "p_value": round(sign_test_p(lw, n), 5),
        }

    by_session = defaultdict(list)
    by_prompt = defaultdict(list)
    for r in votes:
        by_session[r.get("session", "?")].append(r)
        by_prompt[r.get("prompt", "?")].append(r)
    return {
        "overall": bucket(votes),
        "sessions": {k: bucket(v) for k, v in sorted(by_session.items())},
        "prompts": {k: bucket(v) for k, v in sorted(by_prompt.items())},
    }


def fitness_rows(votes: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Per-adapter A/B-vote fitness in the trainer's reward-row shape — the
    ingestion seed for an off-policy update that folds human votes back
    into training as one more reward term.

    One JSONL-able row per adapter ("lora" and "base" are just two members
    of a 2-member population), carrying the same keys a trainer epoch row
    does for its reward slice: ``reward/combined_mean`` (the adapter's
    winrate — a [0,1] fitness a standardize-and-update step can consume
    as-is), ``per_prompt_mean`` + ``prompts`` (per-prompt winrate over the
    prompts actually voted on, the trainer's per-prompt attribution
    layout), ``images_scored`` (sample count: every vote scored one image
    of this adapter), and first/last vote timestamps. Zero-vote inputs
    return ``[]`` — a fitness row with no samples is noise, not evidence."""
    if not votes:
        return []
    prompts = sorted({str(r.get("prompt", "?")) for r in votes})
    p_index = {p: i for i, p in enumerate(prompts)}
    ts = [float(r["t"]) for r in votes
          if isinstance(r.get("t"), (int, float))]
    rows = []
    for adapter in ("lora", "base"):
        wins = [r for r in votes if r.get("winner") == adapter]
        per_prompt_n = [0] * len(prompts)
        per_prompt_w = [0] * len(prompts)
        for r in votes:
            j = p_index[str(r.get("prompt", "?"))]
            per_prompt_n[j] += 1
            if r.get("winner") == adapter:
                per_prompt_w[j] += 1
        rows.append({
            "adapter": adapter,
            "member": 0 if adapter == "lora" else 1,
            "reward/combined_mean": round(len(wins) / len(votes), 6),
            "per_prompt_mean": [
                round(w / n, 6) if n else None
                for w, n in zip(per_prompt_w, per_prompt_n)
            ],
            "per_prompt_n": per_prompt_n,
            "prompts": prompts,
            "images_scored": len(votes),
            "n_sessions": len({r.get("session", "?") for r in votes}),
            "ts_first": min(ts) if ts else None,
            "ts_last": max(ts) if ts else None,
            "source": "votes",
        })
    return rows


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Blind A/B vote report")
    p.add_argument("votes", help="votes.jsonl written by tools/demo.py")
    p.add_argument("--out_json", default=None)
    p.add_argument("--fitness_out", default=None,
                   help="also emit per-adapter fitness rows (JSONL, trainer "
                        "reward-row schema: reward/combined_mean winrate + "
                        "per_prompt_mean + sample counts + timestamps) — "
                        "the off-policy update's ingestion format")
    args = p.parse_args(argv)
    votes = load_votes(Path(args.votes))
    rep = report(votes)
    o = rep["overall"]
    print(
        f"{o['n']} votes — LoRA {o['lora_wins']} : {o['base_wins']} Base "
        f"(winrate {o['lora_winrate']}, sign-test p={o['p_value']})"
    )
    for k, b in rep["prompts"].items():
        print(f"  {k[:60]!r}: {b['lora_wins']}/{b['n']}")
    if args.out_json:
        Path(args.out_json).write_text(json.dumps(rep, indent=2))
    if args.fitness_out:
        rows = fitness_rows(votes)
        Path(args.fitness_out).write_text(
            "".join(json.dumps(r) + "\n" for r in rows)
        )
        print(f"fitness rows → {args.fitness_out} ({len(rows)} adapter(s))")


if __name__ == "__main__":
    main()
