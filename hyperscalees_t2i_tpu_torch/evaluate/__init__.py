"""Evaluation harness: PartiPrompts-style benchmark generation
(``run_benchmark``) and folder scoring (``score_folder``); port of
``hyperscalees_t2i_tpu/evaluate``."""
