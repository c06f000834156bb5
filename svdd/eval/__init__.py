"""Evaluation suite: streaming metrics, distributional distances,
reward-quantile reports."""

from svdd.eval import metrics  # noqa: F401
