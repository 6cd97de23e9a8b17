"""Dataset serialization helpers.

A copy of the JAX package's ``utils/dataset.py``.

reference: luminoth/utils/dataset.py:18-59 (XML → dict for Pascal VOC,
image reading). The tf.train.Feature helpers live in the TF-free codec
(``formats/example_pb.py``) instead.
"""

import xml.etree.ElementTree as ET


def node_to_dict(node):
    """Recursively convert an XML node into a dict (repeated tags → list)."""
    if len(node) == 0:
        return node.text

    result = {}
    for child in node:
        value = node_to_dict(child)
        if child.tag in result:
            if not isinstance(result[child.tag], list):
                result[child.tag] = [result[child.tag]]
            result[child.tag].append(value)
        else:
            result[child.tag] = value
    return result


def read_xml(path):
    """Parse an annotation XML file into a plain dict."""
    tree = ET.parse(path)
    root = tree.getroot()
    result = node_to_dict(root)
    # Normalize 'object' to always be a list.
    if "object" in result and not isinstance(result["object"], list):
        result["object"] = [result["object"]]
    return result


def read_image_bytes(path):
    """Read raw encoded image bytes from disk."""
    with open(path, "rb") as f:
        return f.read()


def image_size(path_or_bytes):
    """(width, height, depth) of an image without full decode."""
    from PIL import Image

    if isinstance(path_or_bytes, bytes):
        import io

        img = Image.open(io.BytesIO(path_or_bytes))
    else:
        img = Image.open(path_or_bytes)
    width, height = img.size
    depth = len(img.getbands())
    return width, height, depth
