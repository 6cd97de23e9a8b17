"""Merge several TFRecord files into one.

A copy of the JAX package's ``tools/dataset/merge.py``.

reference: luminoth/tools/dataset/merge.py:5-36.
"""

import logging

import click

from luminoth_tpu_torch.formats.tfrecord import TFRecordWriter, read_tfrecords

logger = logging.getLogger(__name__)


@click.command()
@click.argument("src", nargs=-1)
@click.argument("dst", nargs=1)
@click.option("--debug", is_flag=True, help="Set level logging to DEBUG.")
def merge(src, dst, debug):
    """Merge (concatenate) multiple TFRecord files into one."""
    logging.basicConfig(level=logging.DEBUG if debug else logging.INFO)

    total = 0
    with TFRecordWriter(dst) as writer:
        for path in src:
            count = 0
            for record in read_tfrecords(path):
                writer.write(record)
                count += 1
            logger.info("%s: %d records", path, count)
            total += count
    click.echo(f"Saved {total} records to {dst}.")
