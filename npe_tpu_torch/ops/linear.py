"""Dense layer (Lasagne DenseLayer semantics, weight (num_inputs, num_units)).

Flattening order: npe_tpu carries NHWC maps and flattens them (H, W, C), and
its dense weights' rows follow that order (the checkpoint ABI). The port
carries NCHW maps, so it puts channels last before flattening; the weights
then need no permutation at load time.
"""


def dense(x, w, b=None):
    if x.ndim == 4:
        x = x.permute(0, 2, 3, 1)
    if x.ndim > 2:
        x = x.reshape(x.shape[0], -1)
    y = x @ w
    if b is not None:
        y = y + b
    return y
