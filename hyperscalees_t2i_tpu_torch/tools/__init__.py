"""Command-line tools of the port: the rung runner (``bench``) with its report
(``bench_report``) and measurement window (``window``), the dispatch-tax row (``dispatch_tax``), the
open-loop load harness (``loadgen``), the draw-loop A/B (``ab_draw_loop``),
the run tools (``trace_report``, ``run_report``, ``sentry``, ``preflight``)
and the user tools around a trained adapter: the blind A/B demo (``demo``)
with its vote report (``vote_report``), the prompt encoder
(``encode_prompts``) and the σ/lr sweep (``sweep``)."""
