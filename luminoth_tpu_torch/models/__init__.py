"""Model registry (counterpart of the JAX package's ``models/__init__.py``)."""


def get_model(model_type):
    if model_type == "ssd":
        from luminoth_tpu_torch.models.ssd import SSD

        return SSD
    if model_type == "fasterrcnn":
        from luminoth_tpu_torch.models.fasterrcnn import FasterRCNN

        return FasterRCNN
    raise ValueError('Invalid model type "{}"'.format(model_type))
