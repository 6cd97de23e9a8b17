"""Dataset conversion CLI: reader → TFRecord writer per split.

A copy of the JAX package's ``tools/dataset/transform.py``.

reference: luminoth/tools/dataset/transform.py:10-73.
"""

import logging

import click

from luminoth_tpu_torch.datasets.exceptions import InvalidDataDirectory
from luminoth_tpu_torch.tools.dataset.readers import get_reader
from luminoth_tpu_torch.tools.dataset.writers import ObjectDetectionWriter
from luminoth_tpu_torch.utils.config import parse_override

logger = logging.getLogger(__name__)


@click.command()
@click.option(
    "dataset_reader", "--type",
    type=click.Choice(["coco", "csv", "flat", "imagenet", "openimages",
                       "pascal", "taggerine"]),
    required=True)
@click.option("--data-dir", required=True,
              help="Directory holding the source annotations/images.")
@click.option("--output-dir", required=True,
              help="Destination directory for the TFRecord output.")
@click.option("splits", "--split", required=True, multiple=True,
              help="Dataset split(s) to convert, e.g. train/val/test.")
@click.option("--only-classes",
              help="Class whitelist (comma-separated names).")
@click.option("--only-images",
              help="Image-id whitelist (useful for overfit experiments).")
@click.option("--limit-examples", type=int,
              help="Stop after converting N examples.")
@click.option("--class-examples", type=int,
              help="Per-class quota: stop once every class has ~N boxes.")
@click.option("overrides", "--override", "-o", multiple=True,
              help="Reader-specific kwargs as key=value pairs.")
@click.option("--debug", is_flag=True, help="Verbose logging.")
def transform(dataset_reader, data_dir, output_dir, splits, only_classes,
              only_images, limit_examples, class_examples, overrides, debug):
    """Convert an annotation format into one TFRecords file per split."""
    logging.basicConfig(level=logging.DEBUG if debug else logging.INFO)

    try:
        reader = get_reader(dataset_reader)
    except ValueError as e:
        click.echo(f"Error getting reader: {e}")
        return

    # The first split fixes the class list; later splits reuse it so
    # label indices stay consistent across train/val/test.
    classes = None
    reader_kwargs = parse_override(list(overrides))

    try:
        for split in splits:
            split_reader = reader(
                data_dir, split,
                only_classes=only_classes, only_images=only_images,
                limit_examples=limit_examples,
                class_examples=class_examples,
                **reader_kwargs,
            )
            if classes is None:
                classes = split_reader.classes
            else:
                split_reader.classes = classes

            writer = ObjectDetectionWriter(split_reader, output_dir, split)
            writer.save()

            click.echo(f"Composition per class ({split}):")
            for label, count in split_reader._per_class_counter.most_common():
                click.echo(
                    "\t{}: {}".format(split_reader.pretty_name(label), count)
                )
    except InvalidDataDirectory as e:
        click.echo(f"Error reading dataset: {e}")
