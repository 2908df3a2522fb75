from npe_tpu_torch.editor.engine import EditSession  # noqa: F401
