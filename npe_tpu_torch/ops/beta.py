"""RGB-Beta output head pieces (npe_tpu `ops/beta.py`).

Reference `beta_layer` (`layers.py:397-408`): given per-pixel (alpha, beta)
channel pairs, return the Beta-distribution mean rescaled to tanh range:
2 * alpha / (alpha + beta + 1e-8) - 1.
"""


def beta_mean(alpha, beta):
    return 2.0 * (alpha / (alpha + beta + 1e-8)) - 1.0
