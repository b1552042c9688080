"""Command-line tools of the port: the dispatch-tax row (``dispatch_tax``), the
open-loop load harness (``loadgen``) and the draw-loop A/B (``ab_draw_loop``)."""
