"""Interactive inference demo: manual base/LoRA generation and a blind A/B
test (port of ``hyperscalees_t2i_tpu/tools/demo.py``)::

    python -m hyperscalees_t2i_tpu_torch.tools.demo --backend sana_one_step \\
        --encoded_prompts parti.npz --run_dir runs/x --cli 10 --session_seed 0

Base and LoRA are two adapters in one ``serve.ServeEngine``'s store, θ = 0
and the trained tree, served by the same program (on the card a CUDA graph
per geometry); a blind pair is two requests flushed as one adapter-batched
dispatch. The session logic (trial sampling, A/B side randomization, vote
accounting, ``votes.jsonl``) is plain Python; ``--cli N`` runs N trials in
the terminal. The gradio UI (:func:`build_interface`) needs the ``gradio``
package and raises ``ImportError`` without it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import random
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

Pytree = Any


# ---------------------------------------------------------------------------
# engine: one backend, base θ (zeros) + trained θ, one serving engine
# ---------------------------------------------------------------------------


class DemoEngine:
    """Owns the serving engine and both adapters; generates single images.

    "base" and "lora" are two adapters in the engine's store (θ = 0 and the
    trained tree) served by the same program; a blind A/B pair is submitted
    as two requests and flushed as one adapter-batched dispatch. A guidance
    other than the backend's is a program of its own, cached by the engine
    after its first use."""

    def __init__(self, backend, lora_theta: Optional[Pytree] = None,
                 theta_template: Optional[Pytree] = None):
        from ..serve import ServeConfig, ServeEngine
        from ..utils import threefry
        from ..utils.pytree import zero_like_theta

        self.backend = backend
        if theta_template is None:
            theta_template = backend.init_theta(threefry.prng_key(0, "cpu"))
        self.base_theta = zero_like_theta(theta_template)
        # adapter_batch=2: a blind A/B trial (base + lora, same seed) fills
        # exactly one serve batch; manual single generations pad one slot
        self.serve = ServeEngine(
            backend,
            ServeConfig(adapter_batch=2, images_per_request=1, device=backend.device),
            theta_template=theta_template,
        )
        self.serve.put_adapter("base", self.base_theta)
        self._lora_theta: Optional[Pytree] = None
        if lora_theta is not None:
            self.lora_theta = lora_theta

    @property
    def lora_theta(self) -> Optional[Pytree]:
        return self._lora_theta

    @lora_theta.setter
    def lora_theta(self, value: Optional[Pytree]) -> None:
        # assigning a trained adapter (make_engine, tests) registers it in
        # the serve store — a hot swap, never a recompile
        self._lora_theta = value
        if value is not None:
            self.serve.put_adapter("lora", value)

    @property
    def prompts(self) -> List[str]:
        return list(self.backend.texts)

    @property
    def num_prompts(self) -> int:
        return self.backend.num_items

    @property
    def default_guidance(self) -> Optional[float]:
        """None for backends without a scalar guidance knob (var/infinity use
        per-scale cfg lists — override via their config flags instead)."""
        return self.serve.default_guidance

    def _adapter_id(self, which: str) -> str:
        if which == "lora":
            if self._lora_theta is None:
                raise ValueError("no LoRA adapter loaded (start with --run_dir)")
            return "lora"
        return "base"

    def generate_one(
        self,
        which: str,
        prompt_index: int,
        seed: int,
        guidance_scale: Optional[float] = None,
    ) -> np.ndarray:
        """One image [H, W, 3] uint8 for ``which`` in {"base", "lora"}."""
        from ..utils.images import to_uint8

        img = self.serve.generate(
            self._adapter_id(which), [int(prompt_index)], int(seed),
            guidance=guidance_scale,
        )
        return to_uint8(np.asarray(img[0], np.float32))

    def generate_pair(
        self, prompt_index: int, seed: int, guidance_scale: Optional[float] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(base, lora) at the same seed, dispatched as one adapter-batched
        serve call (both requests coalesce into the engine's lanes)."""
        from ..utils.images import to_uint8

        rb = self.serve.submit(self._adapter_id("base"), [int(prompt_index)],
                               int(seed), guidance=guidance_scale)
        rl = self.serve.submit(self._adapter_id("lora"), [int(prompt_index)],
                               int(seed), guidance=guidance_scale)
        by_id = {r.request.request_id: r for r in self.serve.flush()}
        base = to_uint8(np.asarray(by_id[rb.request_id].images[0], np.float32))
        lora = to_uint8(np.asarray(by_id[rl.request_id].images[0], np.float32))
        return base, lora


# ---------------------------------------------------------------------------
# blind A/B session
# ---------------------------------------------------------------------------


def format_score(scores: Dict[str, int]) -> str:
    """Session scoreboard text."""
    n = scores.get("n_trials", 0)
    lw = scores.get("lora_wins", 0)
    bw = scores.get("base_wins", 0)
    if n <= 0:
        return "Session score: no votes yet. Hit **Test it!** and start choosing."
    return (
        f"Session score: {n} votes — LoRA wins: {lw}, Base wins: {bw} "
        f"(LoRA win rate: {100.0 * lw / n:.1f}%)"
    )


@dataclasses.dataclass
class Trial:
    img_a: np.ndarray
    img_b: np.ndarray
    prompt_index: int
    prompt_text: str
    seed: int
    mapping: Dict[str, str]  # {"A": "base"|"lora", "B": ...}


class BlindABSession:
    """Trial sampling + side randomization + vote accounting.

    Votes append to ``votes.jsonl`` under ``record_dir`` so a session's
    human-eval outcome survives the process. The draws from ``rng`` are the
    reference's, in its order: ``randrange`` (prompt), ``randint`` (seed),
    ``random`` (sides).
    """

    def __init__(self, engine: DemoEngine, rng: Optional[random.Random] = None,
                 record_dir: Optional[Path] = None):
        import uuid

        self.engine = engine
        self.rng = rng or random.Random()
        self.record_dir = Path(record_dir) if record_dir else None
        self.scores = {"n_trials": 0, "lora_wins": 0, "base_wins": 0}
        self.current: Optional[Trial] = None
        # concurrent clients share one votes.jsonl — the id disaggregates them
        self.session_id = uuid.uuid4().hex[:12]

    def new_trial(self, guidance_scale: Optional[float] = None) -> Trial:
        idx = self.rng.randrange(self.engine.num_prompts)
        seed = self.rng.randint(0, 10_000)
        base, lora = self.engine.generate_pair(idx, seed, guidance_scale)
        if self.rng.random() < 0.5:
            img_a, img_b, mapping = base, lora, {"A": "base", "B": "lora"}
        else:
            img_a, img_b, mapping = lora, base, {"A": "lora", "B": "base"}
        self.current = Trial(
            img_a=img_a, img_b=img_b, prompt_index=idx,
            prompt_text=self.engine.prompts[idx], seed=seed, mapping=mapping,
        )
        return self.current

    def vote(self, choice: str) -> Dict[str, int]:
        """Record a vote for side "A" or "B"; returns updated scores."""
        if self.current is None:
            raise ValueError("no active trial — call new_trial() first")
        winner = self.current.mapping.get(choice)
        if winner not in ("base", "lora"):
            raise ValueError(f"invalid choice {choice!r} (want 'A' or 'B')")
        self.scores["n_trials"] += 1
        self.scores["lora_wins" if winner == "lora" else "base_wins"] += 1
        if self.record_dir is not None:
            self.record_dir.mkdir(parents=True, exist_ok=True)
            rec = {
                "t": time.time(),
                "session": self.session_id,
                "prompt_index": self.current.prompt_index,
                "prompt": self.current.prompt_text,
                "seed": self.current.seed,
                "choice": choice,
                "winner": winner,
                **self.scores,
            }
            with open(self.record_dir / "votes.jsonl", "a") as f:
                f.write(json.dumps(rec) + "\n")
        self.current = None
        return dict(self.scores)


# ---------------------------------------------------------------------------
# gradio UI (optional dependency)
# ---------------------------------------------------------------------------


def build_interface(engine: DemoEngine, record_dir: Optional[Path] = None,
                    session_seed: Optional[int] = None):
    """Gradio Blocks: a manual mode (base, LoRA or both) and the blind test.

    Each browser client gets its own ``BlindABSession`` via ``gr.State``: a
    shared session would let interleaved Test/Vote events from two tabs
    record votes against the wrong trial's A/B mapping. Raises ImportError
    with guidance when gradio is not installed; ``--cli N`` covers that
    environment.
    """
    try:
        import gradio as gr
    except ImportError as e:  # pragma: no cover - environment-dependent
        raise ImportError(
            "gradio is not installed; use `--cli N` for the terminal blind "
            "test, or install gradio where permitted"
        ) from e

    choices = []
    for i, text in enumerate(engine.prompts):
        short = text.replace("\n", " ")
        if len(short) > 80:
            short = short[:77] + "..."
        choices.append((f"{i:04d} – {short}", i))

    def _slider_guidance(value):
        # backends without a scalar guidance knob (var/infinity) ignore the
        # slider — passing a float would be rejected by _gen_fn
        return float(value) if engine.default_guidance is not None else None

    def generate_fn(mode, prompt_index, seed, guidance):
        if mode in ("lora", "both") and engine.lora_theta is None:
            raise gr.Error("LoRA mode needs --run_dir at startup.")
        guidance = _slider_guidance(guidance)
        base_img = lora_img = None
        if mode in ("base", "both"):
            base_img = engine.generate_one("base", prompt_index, seed, guidance)
        if mode in ("lora", "both"):
            lora_img = engine.generate_one("lora", prompt_index, seed, guidance)
        return base_img, lora_img, engine.prompts[int(prompt_index)]

    def _client_session(sess) -> BlindABSession:
        if sess is None:
            rng = random.Random(session_seed) if session_seed is not None else random.Random()
            sess = BlindABSession(engine, rng=rng, record_dir=record_dir)
        return sess

    def test_fn(guidance, sess):
        if engine.lora_theta is None:
            raise gr.Error("Blind test needs --run_dir at startup.")
        sess = _client_session(sess)
        trial = sess.new_trial(_slider_guidance(guidance))
        return trial.img_a, trial.img_b, trial.prompt_text, format_score(sess.scores), sess

    def vote_fn(choice, sess):
        sess = _client_session(sess)
        try:
            sess.vote(choice)
        except ValueError as e:
            raise gr.Error(str(e))
        return format_score(sess.scores), sess

    with gr.Blocks() as demo:
        session_state = gr.State(None)  # per-client BlindABSession
        gr.Markdown("# EGGROLL-ES × one-step T2I — demo\n## Manual mode")
        with gr.Row():
            mode = gr.Radio(["base", "lora", "both"],
                            value="lora" if engine.lora_theta is not None else "base",
                            label="Model")
            prompt_dd = gr.Dropdown(choices=choices, value=0, label="Prompt")
        with gr.Row():
            seed = gr.Slider(0, 10_000, value=0, step=1, label="Seed")
            guidance = gr.Slider(0.0, 10.0, value=engine.default_guidance or 0.0,
                                 step=0.1, label="Guidance scale")
        gen_btn = gr.Button("Generate")
        with gr.Row():
            base_out = gr.Image(label="Base")
            lora_out = gr.Image(label="LoRA")
        prompt_out = gr.Textbox(label="Prompt text", interactive=False)
        gen_btn.click(generate_fn, [mode, prompt_dd, seed, guidance],
                      [base_out, lora_out, prompt_out])

        gr.Markdown("---\n## Blind A/B test")
        test_btn = gr.Button("Test it! (random prompt & seed)")
        with gr.Row():
            img_a = gr.Image(label="Image A")
            img_b = gr.Image(label="Image B")
        test_prompt = gr.Textbox(label="Prompt text (for this test)", interactive=False)
        with gr.Row():
            vote_a = gr.Button("A is better")
            vote_b = gr.Button("B is better")
        score_md = gr.Markdown(format_score({}))
        test_btn.click(test_fn, [guidance, session_state],
                       [img_a, img_b, test_prompt, score_md, session_state])
        vote_a.click(lambda s: vote_fn("A", s), [session_state], [score_md, session_state])
        vote_b.click(lambda s: vote_fn("B", s), [session_state], [score_md, session_state])
    return demo


# ---------------------------------------------------------------------------
# terminal fallback + entry point
# ---------------------------------------------------------------------------


def run_cli_trials(session: BlindABSession, n: int, out_dir: Path,
                   input_fn=input, guidance: Optional[float] = None) -> Dict[str, int]:
    """Blind A/B in the terminal: saves A/B images per trial, reads a vote
    from stdin, records to votes.jsonl. Works in images without gradio."""
    from ..utils.images import save_image

    out_dir.mkdir(parents=True, exist_ok=True)
    for t in range(n):
        trial = session.new_trial(guidance)
        pa = out_dir / f"trial{t:03d}_A.png"
        pb = out_dir / f"trial{t:03d}_B.png"
        save_image(trial.img_a, pa)
        save_image(trial.img_b, pb)
        print(f"[trial {t}] prompt: {trial.prompt_text!r}  (seed {trial.seed})")
        print(f"  A: {pa}\n  B: {pb}")
        choice = ""
        while choice not in ("A", "B"):
            choice = input_fn("Which is better? [A/B] ").strip().upper()
        session.vote(choice)
        print("  " + format_score(session.scores))
    return dict(session.scores)


def build_parser() -> argparse.ArgumentParser:
    from ..train.cli import add_backend_flags

    p = argparse.ArgumentParser(description="Base-vs-LoRA demo with blind A/B voting (PyTorch port)")
    add_backend_flags(p)
    p.add_argument("--run_dir", default=None,
                   help="training run dir with latest_theta.npz (the LoRA side)")
    p.add_argument("--share", action="store_true", help="gradio share link")
    p.add_argument("--cli", type=int, default=0, metavar="N",
                   help="run N blind trials in the terminal instead of launching gradio")
    p.add_argument("--out_dir", default="demo_out", help="image dir for --cli mode")
    p.add_argument("--session_seed", type=int, default=None,
                   help="seed trial sampling (reproducible blind sessions)")
    return p


def make_engine(args) -> DemoEngine:
    from ..device import resolve_device
    from ..train.checkpoints import load_checkpoint
    from ..train.cli import build_backend
    from ..utils import threefry

    device = resolve_device(args.device)
    backend = build_backend(args, device)
    backend.setup()
    template = backend.init_theta(threefry.prng_key(0, "cpu"))
    lora_theta = None
    if args.run_dir:
        restored = load_checkpoint(Path(args.run_dir), template)
        if restored is None:
            raise SystemExit(f"no loadable checkpoint in {args.run_dir}")
        lora_theta, epoch = restored
        print(f"[demo] loaded adapter from epoch {epoch}", flush=True)
    return DemoEngine(backend, lora_theta, theta_template=template)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.cli <= 0:
        # fail in milliseconds, not after a full model build, when the UI
        # dependency is missing
        try:
            import gradio  # noqa: F401
        except ImportError as e:
            raise SystemExit(
                "gradio is not installed; rerun with `--cli N` for the "
                "terminal blind test"
            ) from e
    if args.cli > 0 and not args.run_dir:
        raise SystemExit("blind test needs a trained adapter — pass --run_dir")
    engine = make_engine(args)
    record_dir = Path(args.run_dir) if args.run_dir else Path(args.out_dir)
    if args.cli > 0:
        rng = random.Random(args.session_seed) if args.session_seed is not None else random.Random()
        session = BlindABSession(engine, rng=rng, record_dir=record_dir)
        run_cli_trials(session, args.cli, Path(args.out_dir))
        return
    demo = build_interface(engine, record_dir=record_dir, session_seed=args.session_seed)
    demo.launch(share=args.share)


if __name__ == "__main__":
    main()
