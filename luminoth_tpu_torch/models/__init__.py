"""Model registry (the port has Faster R-CNN; SSD is still to port)."""


def get_model(model_type):
    if model_type == "fasterrcnn":
        from luminoth_tpu_torch.models.fasterrcnn import FasterRCNN

        return FasterRCNN
    if model_type == "ssd":
        raise NotImplementedError("SSD is not ported to PyTorch yet")
    raise ValueError('Invalid model type "{}"'.format(model_type))
