"""Checkpoint zoo of the port: local index, bundles, remote download, CLI.

Counterpart of the JAX package's ``tools/checkpoint/__init__.py``, with the
same home (``LUMI_HOME``, default ``~/.luminoth_tpu``), index and bundle
layout, so one zoo serves both packages. Bundles live under
``<home>/checkpoints/<id>/`` and hold ``config.yml`` (with
``train.job_dir`` pointing at the bundle), ``classes.json`` and the weights
as ``ckpt_step_<N>.msgpack`` with ``{"step", "params", "batch_stats"}`` in
the flax layout and no optimizer state. ``create`` writes that file from
either package's training checkpoint: the port's ``.pt`` goes through
``utils/weights.flax_variables_from_torch`` and the port's msgpack writer.

A remote index is any ``urllib`` URL in ``LUMI_REMOTE_INDEX_URL``
(``file://`` for a shared filesystem); there is no hosted default, so
nothing is fetched unless it is set.

Not ported: ``convert-backbone --source slim`` and ``convert-detector``
read TensorFlow checkpoints, and ``download-backbone`` needs the network;
each raises ``NotImplementedError``.
"""

import json
import os
import shutil
import tarfile
import tempfile
import uuid

import click

from luminoth_tpu_torch.utils.config import (
    Config,
    dump_config,
    get_base_config,
    get_config,
    get_model_config,
    load_config_files,
)
from luminoth_tpu_torch.utils.homedir import get_home

CHECKPOINT_INDEX = "checkpoints.json"
CHECKPOINT_PATH = "checkpoints"

# Remote zoo index URL: no hosted default. Point LUMI_REMOTE_INDEX_URL at
# an index made by `checkpoint create` + `export` + `build-index`.
REMOTE_INDEX_URL = ""


def get_remote_index_url():
    """Resolve the remote index URL at call time (env wins)."""
    return os.environ.get("LUMI_REMOTE_INDEX_URL") or REMOTE_INDEX_URL


def get_checkpoints_directory():
    path = os.path.join(get_home(), CHECKPOINT_PATH)
    os.makedirs(path, exist_ok=True)
    return path


def get_checkpoint_path(checkpoint_id):
    return os.path.join(get_checkpoints_directory(), checkpoint_id)


def read_checkpoint_db():
    path = os.path.join(get_checkpoints_directory(), CHECKPOINT_INDEX)
    if not os.path.exists(path):
        return {"checkpoints": []}
    with open(path) as f:
        return json.load(f)


def save_checkpoint_db(db):
    path = os.path.join(get_checkpoints_directory(), CHECKPOINT_INDEX)
    with open(path, "w") as f:
        json.dump(db, f, indent=2)


def get_checkpoint(db, id_or_alias):
    """Resolve by id, alias or id prefix; local entries win over remote."""
    matches = [
        c for c in db["checkpoints"]
        if c["id"] == id_or_alias or c.get("alias") == id_or_alias
    ]
    if not matches:
        matches = [
            c for c in db["checkpoints"]
            if c["id"].startswith(id_or_alias)
        ]
    if not matches:
        return None
    local = [c for c in matches if c.get("source") == "local"]
    return (local or matches)[0]


def merge_into_db(db, entry):
    existing = [
        i for i, c in enumerate(db["checkpoints"]) if c["id"] == entry["id"]
    ]
    if existing:
        db["checkpoints"][existing[0]] = entry
    else:
        db["checkpoints"].append(entry)
    return db


# ------------------------------------------------------------ remote index


def fetch_remote_index():
    """Fetch the remote checkpoint index and merge it into the local db."""
    import urllib.request

    url = get_remote_index_url()
    if not url:
        raise RuntimeError(
            "No remote index configured; set LUMI_REMOTE_INDEX_URL."
        )
    with urllib.request.urlopen(url, timeout=30) as resp:
        remote = json.load(resp)
    db = read_checkpoint_db()
    # Drop stale remote entries, merge fresh ones.
    db["checkpoints"] = [
        c for c in db["checkpoints"] if c.get("source") != "remote"
        or c.get("status") == "DOWNLOADED"
    ]
    for entry in remote.get("checkpoints", []):
        entry = dict(entry)
        entry.setdefault("source", "remote")
        entry.setdefault("status", "NOT_DOWNLOADED")
        if get_checkpoint(db, entry["id"]) is None:
            db["checkpoints"].append(entry)
    save_checkpoint_db(db)
    return db


def safe_extractall(tar, dest):
    """``extractall`` with the "data" safety filter where available.

    The ``filter=`` kwarg only exists from Python 3.10.12 / 3.11.4;
    older patch releases fall back to a manual member-path check.
    """
    try:
        tar.extractall(dest, filter="data")
    except TypeError:
        _extractall_checked(tar, dest)


def _extractall_checked(tar, dest):
    """Manual stand-in for the "data" filter on old Pythons."""
    base = os.path.realpath(dest)
    for member in tar.getmembers():
        # Links can alias paths that realpath cannot resolve until after
        # extraction (a symlink first, then a member routed through it).
        if member.issym() or member.islnk():
            raise RuntimeError(
                f"tar member is a link (rejected): {member.name}"
            )
        target = os.path.realpath(os.path.join(dest, member.name))
        if target != base and not target.startswith(base + os.sep):
            raise RuntimeError(
                f"tar member escapes destination: {member.name}"
            )
    tar.extractall(dest)


def _is_flat(names):
    """Whether a bundle tar is flat (``config.yml`` and the rest at its
    root). Members named ``./config.yml``, as ``tar -C dir .`` writes
    them, are flat: their single root ``.`` is not an ``<id>/`` root."""
    if any(n == "." or n.startswith("./") for n in names):
        return True
    roots = {n.split("/")[0] for n in names}
    return not (len(roots) == 1 and any("/" in n for n in names))


def download_remote_checkpoint(db, entry):
    """Download and unpack a remote checkpoint tarball."""
    import urllib.request

    target = get_checkpoint_path(entry["id"])
    os.makedirs(target, exist_ok=True)
    tar_path = os.path.join(target, "checkpoint.tar")
    with urllib.request.urlopen(entry["url"], timeout=120) as resp:
        with open(tar_path, "wb") as f:
            shutil.copyfileobj(resp, f)
    with tarfile.open(tar_path) as tar:
        names = [n for n in tar.getnames() if n != "checkpoint.tar"]
        rooted = bool(names) and all(
            n == entry["id"] or n.startswith(entry["id"] + "/")
            for n in names
        )
        # export() bundles members under an <id>/ root: extract those into
        # the checkpoints directory so the bundle lands at
        # checkpoints/<id>/. Flat tars extract straight into the target.
        safe_extractall(tar, os.path.dirname(target) if rooted else target)
    os.remove(tar_path)
    entry["status"] = "DOWNLOADED"
    merge_into_db(db, entry)
    save_checkpoint_db(db)


# ------------------------------------------------------- config resolution


def get_checkpoint_config(id_or_alias, prompt=True):
    """Resolve a checkpoint reference to a ready-to-use config, downloading
    the bundle first when it is remote (``prompt``)."""
    db = read_checkpoint_db()
    entry = get_checkpoint(db, id_or_alias)
    if entry is None and prompt:
        # Try refreshing the remote index once.
        try:
            db = fetch_remote_index()
            entry = get_checkpoint(db, id_or_alias)
        except Exception:
            pass
    if entry is None:
        raise ValueError(
            "Checkpoint '{}' not found in index.".format(id_or_alias)
        )
    if entry.get("status", "LOCAL") == "NOT_DOWNLOADED":
        if not prompt:
            raise ValueError(
                "Checkpoint '{}' not downloaded.".format(id_or_alias)
            )
        click.echo("Checkpoint not present locally. Downloading...")
        download_remote_checkpoint(db, entry)

    path = get_checkpoint_path(entry["id"])
    config = load_config_files([os.path.join(path, "config.yml")])
    config.train.job_dir = path
    config.train.run_name = None
    return get_model_config(get_base_config(config.model.type), config, None)


def get_checkpoint_class_labels(id_or_alias):
    db = read_checkpoint_db()
    entry = get_checkpoint(db, id_or_alias)
    if entry is None:
        return None
    path = os.path.join(get_checkpoint_path(entry["id"]), "classes.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return None


# ---------------------------------------------------------------- bundles


def bundle_state(state, step, config):
    """The zoo's ``{"step", "params", "batch_stats"}`` of a training
    checkpoint ``state`` of either package, optimizer state stripped.

    A port ``.pt`` state holds the model's state dict, which goes to the
    flax layout through a model built on the meta device (no memory for
    its own weights); a JAX train state holds the flax trees already.
    """
    if "model" not in state:
        return {"step": state.get("step", step), "params": state["params"],
                "batch_stats": state.get("batch_stats", {})}
    import torch

    from luminoth_tpu_torch.models import get_model
    from luminoth_tpu_torch.utils.weights import (
        flax_variables_from_torch,
        nest_variables,
    )

    with torch.device("meta"):
        model = get_model(config.model.type)(config)
    model.load_state_dict(state["model"], strict=True, assign=True)
    variables = nest_variables(flax_variables_from_torch(model))
    return {"step": int(state.get("step", step)),
            "params": variables["params"],
            "batch_stats": variables.get("batch_stats", {})}


def write_bundle(target, config, state, step):
    """A bundle in ``target``: the weights, the ``checkpoint`` marker, the
    config (``train.job_dir`` at the bundle) and the dataset's
    ``classes.json`` where there is one."""
    from luminoth_tpu_torch.formats import msgpack

    os.makedirs(target, exist_ok=True)
    msgpack.dump(bundle_state(state, step, config),
                 os.path.join(target, f"ckpt_step_{step}.msgpack"))
    with open(os.path.join(target, "checkpoint"), "w") as f:
        json.dump({"latest_step": step}, f)
    bundle_config = Config(config)
    bundle_config.train.job_dir = target
    bundle_config.train.run_name = None
    with open(os.path.join(target, "config.yml"), "w") as f:
        f.write(dump_config(bundle_config))
    classes_path = os.path.join(config.dataset.dir, "classes.json")
    if os.path.exists(classes_path):
        shutil.copy(classes_path, os.path.join(target, "classes.json"))


# ------------------------------------------------------------ CLI commands


@click.group(help="Groups of commands to manage checkpoints")
def checkpoint():
    pass


@checkpoint.command("list", help="List available checkpoints.")
def list_checkpoints():
    db = read_checkpoint_db()
    template = "| {:>12} | {:>6} | {:>14} | {:>8} | {:>14} |"
    click.echo(template.format("id", "name", "alias", "source", "status"))
    click.echo("|" + "-" * 68 + "|")
    for c in db["checkpoints"]:
        click.echo(
            template.format(
                c["id"],
                c.get("name", ""),
                c.get("alias", ""),
                c.get("source", "local"),
                c.get("status", "LOCAL"),
            )
        )


@checkpoint.command(help="Display detailed information on checkpoint.")
@click.argument("id_or_alias")
def info(id_or_alias):
    db = read_checkpoint_db()
    entry = get_checkpoint(db, id_or_alias)
    if entry is None:
        click.echo("Checkpoint not found.")
        return
    click.echo(json.dumps(entry, indent=2))


_EDITABLE_FIELDS = (
    "name", "description", "alias", "dataset.name", "dataset.num_classes",
)


def parse_entries(entries):
    """``-e field=value`` metadata entries → dict (None on bad input): a
    whitelisted, possibly dotted field per entry, each at most once."""
    values = []
    for entry in entries:
        field, sep, value = entry.partition("=")
        if not sep:
            click.echo(f"Invalid entry {entry!r}; expected field=value.")
            return None
        values.append((field, value))
    disallowed = [k for k, _ in values if k not in _EDITABLE_FIELDS]
    if disallowed:
        click.echo(
            "The following fields may not be set: "
            + ", ".join(disallowed)
        )
        return None
    if len(values) != len({k for k, _ in values}):
        click.echo("Repeated fields. Each field may be passed exactly once.")
        return None
    return dict(values)


def apply_entries(entry, parsed):
    """Write (possibly dotted) metadata fields into a checkpoint entry."""
    for field, value in parsed.items():
        target = entry
        *parents, leaf = field.split(".")
        for part in parents:
            target = target.setdefault(part, {})
        target[leaf] = value


@checkpoint.command(help="Create a checkpoint from a configuration file.")
@click.argument("config_args", nargs=-1)
@click.option(
    "config_files", "--config", "-c", multiple=True,
    help="Config to use (same as the positional arguments).")
@click.option(
    "override_params", "--override", "-o", multiple=True)
@click.option("--entity", help="Entity that created the checkpoint.")
@click.option("--alias", help="Alias for the new checkpoint.")
@click.option(
    "entries", "--entry", "-e", multiple=True,
    help="Specify checkpoint's metadata field value (field=value).")
def create(config_args, config_files, override_params, entity, alias,
           entries):
    config_files = [*config_args, *config_files]
    if not config_files:
        click.echo("No config file given.")
        return
    parsed_entries = parse_entries(entries)
    if parsed_entries is None:
        return
    from luminoth_tpu_torch.utils.checkpoint_io import CheckpointManager

    config = get_config(config_files, override_params=[*override_params])
    job_dir = config.train.get("job_dir", "jobs/")
    run_name = config.train.get("run_name") or "default"
    source_dir = os.path.join(job_dir, run_name, "ckpt")
    state, step = (None, None)
    if os.path.isdir(source_dir):
        # The newest readable checkpoint: the port's .pt or JAX's .msgpack.
        state, step = CheckpointManager(source_dir).latest_state_dict()
    if state is None:
        click.echo(f"No checkpoint found under {source_dir}.")
        return

    checkpoint_id = str(uuid.uuid4()).replace("-", "")[:12]
    write_bundle(get_checkpoint_path(checkpoint_id), config, state, step)

    db = read_checkpoint_db()
    entry = {
        "id": checkpoint_id,
        "name": run_name,
        "description": "",
        "alias": alias or "",
        "model": config.model.type,
        "dataset": {"name": config.dataset.get("dir", "")},
        "entity": entity or "",
        "source": "local",
        "status": "LOCAL",
    }
    apply_entries(entry, parsed_entries)
    merge_into_db(db, entry)
    save_checkpoint_db(db)
    click.echo(f"Checkpoint {checkpoint_id} created successfully.")


@checkpoint.command(help="Edits the checkpoint's metadata.")
@click.argument("id_or_alias")
@click.option("--alias")
@click.option("--name")
@click.option("--description")
@click.option(
    "entries", "--entry", "-e", multiple=True,
    help="Specify checkpoint's metadata field value (field=value).")
def edit(id_or_alias, alias, name, description, entries):
    parsed_entries = parse_entries(entries)
    if parsed_entries is None:
        return
    db = read_checkpoint_db()
    entry = get_checkpoint(db, id_or_alias)
    if entry is None:
        click.echo("Checkpoint not found.")
        return
    if alias is not None:
        entry["alias"] = alias
    if name is not None:
        entry["name"] = name
    if description is not None:
        entry["description"] = description
    apply_entries(entry, parsed_entries)
    merge_into_db(db, entry)
    save_checkpoint_db(db)
    click.echo("Checkpoint updated.")


@checkpoint.command(help="Removes a checkpoint from the index and disk.")
@click.argument("id_or_alias")
def delete(id_or_alias):
    db = read_checkpoint_db()
    entry = get_checkpoint(db, id_or_alias)
    if entry is None:
        click.echo("Checkpoint not found.")
        return
    db["checkpoints"] = [
        c for c in db["checkpoints"] if c["id"] != entry["id"]
    ]
    save_checkpoint_db(db)
    path = get_checkpoint_path(entry["id"])
    if os.path.isdir(path):
        shutil.rmtree(path)
    click.echo(f"Checkpoint {entry['id']} deleted successfully.")


@checkpoint.command(help="Exports a checkpoint to a tar file.")
@click.argument("id_or_alias")
@click.option("--output", default=".", help="Output directory.")
def export(id_or_alias, output):
    db = read_checkpoint_db()
    entry = get_checkpoint(db, id_or_alias)
    if entry is None:
        click.echo("Checkpoint not found.")
        return
    path = get_checkpoint_path(entry["id"])
    tar_path = os.path.join(output, f"{entry['id']}.tar")
    with tarfile.open(tar_path, "w") as tar:
        # A metadata.json at the bundle's root is left out: the fresh one
        # below is the copy that counts, and tar members with duplicate
        # paths extract in an order-dependent way.
        stale = f"{entry['id']}/metadata.json"
        tar.add(path, arcname=entry["id"], filter=lambda ti: (
            None if ti.name == stale else ti
        ))
        # The index entry goes through a temporary file, so the live
        # bundle holds no copy that later `edit`s would leave stale.
        fd, tmp_path = tempfile.mkstemp(suffix=".json")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(entry, f)
            tar.add(tmp_path, arcname=f"{entry['id']}/metadata.json")
        finally:
            os.unlink(tmp_path)
    click.echo(f"Checkpoint {entry['id']} exported successfully.")


def build_remote_index(tar_dir, base_url=None):
    """Write an ``index.json`` describing the export tarballs in a dir.

    With ``export`` this makes any directory a self-hostable zoo: point
    ``LUMI_REMOTE_INDEX_URL`` at the index (``file://`` for a shared
    filesystem, ``http(s)://`` if served). ``base_url`` rewrites each
    bundle URL's prefix; by default the URLs are the tarballs' own
    ``file://`` absolute paths.
    """
    entries = []
    for fname in sorted(os.listdir(tar_dir)):
        if not fname.endswith(".tar"):
            continue
        path = os.path.join(tar_dir, fname)
        root = fname[:-len(".tar")]
        with tarfile.open(path) as tar:
            try:
                member = tar.extractfile(f"{root}/metadata.json")
                entry = json.load(member)
            except KeyError:
                entry = {"id": root}
        if base_url:
            url = base_url.rstrip("/") + "/" + fname
        else:
            url = "file://" + os.path.abspath(path)
        entry.update(url=url, source="remote", status="NOT_DOWNLOADED")
        entries.append(entry)
    index_path = os.path.join(tar_dir, "index.json")
    with open(index_path, "w") as f:
        json.dump({"checkpoints": entries}, f, indent=2)
    return index_path


@checkpoint.command(
    "build-index",
    help="Build a remote-index file (index.json) from exported tarballs, "
         "making TAR_DIR a self-hostable checkpoint zoo.",
)
@click.argument("tar_dir")
@click.option(
    "--base-url", default=None,
    help="URL prefix the tarballs will be served under (default: their "
         "file:// paths).",
)
def build_index(tar_dir, base_url):
    index_path = build_remote_index(tar_dir, base_url=base_url)
    click.echo(f"Remote index written to {index_path}.")


@checkpoint.command("import", help="Imports a checkpoint tar.")
@click.argument("path")
def import_checkpoint(path):
    with tarfile.open(path) as tar:
        names = tar.getnames()
        if not names:
            raise click.ClickException("Checkpoint tar is empty.")
        if _is_flat(names):
            # config.yml and the rest at the tar's root: extract into a
            # fresh bundle directory, never into the checkpoints directory.
            root = str(uuid.uuid4())[:8]
            safe_extractall(
                tar, os.path.join(get_checkpoints_directory(), root)
            )
        else:
            # export() layout: every member under one <id>/ root.
            root = names[0].split("/")[0]
            safe_extractall(tar, get_checkpoints_directory())
    bundle = os.path.join(get_checkpoints_directory(), root)
    metadata_path = os.path.join(bundle, "metadata.json")
    if os.path.exists(metadata_path):
        with open(metadata_path) as f:
            entry = json.load(f)
    else:
        entry = {"id": root, "source": "local", "status": "LOCAL"}
    if entry.get("id") and entry["id"] != root:
        # The index resolves a bundle by its id, so the directory takes
        # the metadata's id.
        target = os.path.join(get_checkpoints_directory(), entry["id"])
        if os.path.exists(target):
            shutil.rmtree(bundle)
            raise click.ClickException(
                f"Checkpoint {entry['id']} already exists."
            )
        os.rename(bundle, target)
    entry["source"] = "local"
    entry["status"] = "LOCAL"
    db = read_checkpoint_db()
    merge_into_db(db, entry)
    save_checkpoint_db(db)
    click.echo(f"Checkpoint {entry['id']} imported successfully.")


@checkpoint.command(help="Refresh the remote checkpoint index.")
def refresh():
    try:
        fetch_remote_index()
        click.echo("Remote index refreshed.")
    except Exception as e:
        click.echo(f"Could not fetch remote index: {e}")


@checkpoint.command(help="Download a remote checkpoint.")
@click.argument("id_or_alias")
def download(id_or_alias):
    db = read_checkpoint_db()
    entry = get_checkpoint(db, id_or_alias)
    if entry is None:
        click.echo("Checkpoint not found.")
        return
    if entry.get("status") != "NOT_DOWNLOADED":
        click.echo("Checkpoint is already downloaded.")
        return
    download_remote_checkpoint(db, entry)
    click.echo("Checkpoint downloaded.")


_NEEDS_TF = (
    "reading TF-slim and TF detector checkpoints needs tensorflow, which "
    "the port does not use: convert them with the JAX package's `lumi "
    "checkpoint` ({what}) and load its output"
)


@checkpoint.command(
    "convert-backbone",
    help="Convert pretrained torchvision backbone weights (.pth) into "
         "native .npz weights.",
)
@click.argument("ckpt_path")
@click.argument("out_path")
@click.option(
    "--architecture", default="resnet_v1_101",
    help="Target architecture (resnet_v{1,2}_{50,101,152}, vgg_16 or "
         "truncated_vgg_16).",
)
@click.option(
    "--source", type=click.Choice(["auto", "slim", "torchvision"]),
    default="auto",
    help="Checkpoint format; 'auto' picks slim for .ckpt prefixes and "
         "torchvision for .pth files. Only torchvision is ported.",
)
def convert_backbone(ckpt_path, out_path, architecture, source):
    if source == "auto":
        base = ckpt_path.rsplit("/", 1)[-1]
        if base.endswith((".pth", ".pt")):
            source = "torchvision"
        elif ".ckpt" in base or not os.path.splitext(base)[1]:
            source = "slim"
        else:
            raise click.UsageError(
                f"Can't infer the checkpoint format of '{ckpt_path}': "
                "expected a torchvision .pth/.pt file or a slim .ckpt "
                "prefix. Pass --source explicitly."
            )
    if source == "slim":
        raise NotImplementedError(
            _NEEDS_TF.format(what="convert-backbone --source slim"))
    from luminoth_tpu_torch.tools.checkpoint.convert import (
        convert_backbone_file,
    )

    count = convert_backbone_file(ckpt_path, out_path, architecture)
    click.echo(f"Converted {count} arrays to {out_path}.")


@checkpoint.command(
    "convert-detector",
    help="Convert a trained TF detector checkpoint (not ported: needs "
         "tensorflow).",
)
@click.argument("ckpt_path")
@click.argument("out_dir")
@click.option("config_files", "--config", "-c", multiple=True)
def convert_detector(ckpt_path, out_dir, config_files):
    raise NotImplementedError(_NEEDS_TF.format(what="convert-detector"))


@checkpoint.command(
    "download-backbone",
    help="Download and convert pretrained backbone weights (not ported: "
         "needs the network).",
)
@click.argument("architecture")
@click.option("--output", "-o", default=None)
@click.option("--source", type=click.Choice(["slim", "torchvision"]),
              default="slim")
def download_backbone_cmd(architecture, output, source):
    from luminoth_tpu_torch.tools.checkpoint.convert import download_backbone

    download_backbone(architecture)
