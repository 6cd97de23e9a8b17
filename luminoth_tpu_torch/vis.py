"""Drawing utilities for rendering detections on images.

reference: luminoth/vis.py:40-181 (d3 category10 colormap, rectangle +
label drawing, ``vis_objects`` entry point).
"""

import numpy as np
from PIL import Image, ImageDraw, ImageFont

# d3's category10.
CATEGORY10 = [
    (31, 119, 180),
    (255, 127, 14),
    (44, 160, 44),
    (214, 39, 40),
    (148, 103, 189),
    (140, 86, 75),
    (227, 119, 194),
    (127, 127, 127),
    (188, 189, 34),
    (23, 190, 207),
]


def build_colormap():
    """Stable label → color assignment."""
    mapping = {}

    def colormap(label):
        label = str(label)
        if label not in mapping:
            mapping[label] = CATEGORY10[len(mapping) % len(CATEGORY10)]
        return mapping[label]

    return colormap


def draw_rectangle(draw, coords, color, width=2, fill_alpha=0):
    """Draw a box outline (and optional translucent fill)."""
    x1, y1, x2, y2 = [int(round(c)) for c in coords[:4]]
    if fill_alpha:
        draw.rectangle(
            [x1, y1, x2, y2], fill=tuple(color) + (int(fill_alpha),)
        )
    for i in range(width):
        draw.rectangle(
            [x1 - i, y1 - i, x2 + i, y2 + i], outline=tuple(color) + (255,)
        )


def draw_label(draw, coords, label, prob, color, scale=1):
    """Draw the label text at the box's top-left corner.

    ``scale`` multiplies the font size (reference vis.py:109-135
    semantics: the default font scaled by the caller's ``scale``).
    """
    x1, y1 = int(round(coords[0])), int(round(coords[1]))
    if prob is not None:
        text = "{} ({:.2f})".format(label, float(prob))
    else:
        text = str(label)
    font = None
    try:
        if scale and float(scale) != 1.0:
            # Pillow >= 9.2 supports sizing the built-in bitmap font.
            font = ImageFont.load_default(size=10 * float(scale))
        else:
            font = ImageFont.load_default()
    except Exception:
        try:
            font = ImageFont.load_default()
        except Exception:
            font = None
    draw.text((x1 + 2, y1 + 2), text, fill=tuple(color) + (255,), font=font)


def vis_objects(image, objects, colormap=None, labels=True, scale=1,
                fill=30):
    """Draw detected objects onto an image.

    Args:
        image: (H, W, 3) ndarray (uint8 or float 0-255).
        objects: list of dicts with ``bbox``, ``label`` and optional
            ``prob`` (the ``Detector.predict`` output format), or a
            single such dict.
        fill: 0..255 alpha for the translucent box fill (reference
            vis.py:138 semantics; booleans also accepted).

    Returns:
        PIL Image with the drawn detections.
    """
    if colormap is None:
        colormap = build_colormap()
    if isinstance(objects, dict):
        objects = [objects]
    if fill is True:
        fill = 40
    fill_alpha = int(fill or 0)

    image = Image.fromarray(
        np.clip(np.asarray(image), 0, 255).astype(np.uint8)
    ).convert("RGBA")
    overlay = Image.new("RGBA", image.size, (0, 0, 0, 0))
    draw = ImageDraw.Draw(overlay)

    for obj in objects:
        bbox = obj["bbox"] if isinstance(obj, dict) else obj
        label = obj.get("label", "") if isinstance(obj, dict) else ""
        prob = obj.get("prob") if isinstance(obj, dict) else None
        color = colormap(label)
        draw_rectangle(draw, bbox, color, fill_alpha=fill_alpha)
        if labels:
            draw_label(draw, bbox, label, prob, color, scale=scale)

    return Image.alpha_composite(image, overlay).convert("RGB")
