"""Model zoo CLI (port of `optispeech_tpu/cli/models.py`): list and download
exported artifacts from an index.

The port's artifacts are `export/exporter.py` directories (load one with
`ExportedOptiSpeech(dir)`, `cli/speak.py` or `cli/serve.py`). The zoo's base
URL comes from `--zoo-url` or $OPTISPEECH_TPU_TORCH_MODEL_ZOO; there is no
default. The index is `<base>/models.json`:

    {"models": [{"id": ..., "name": ..., "lang": ..., "files": [subpaths]}]}

Fetching uses only the standard library (`urllib`, so `file://` works too).
An index entry whose subpath would land outside the destination is refused.

Usage:
    python -m optispeech_tpu_torch.cli.models [--zoo-url URL] ls
    python -m optispeech_tpu_torch.cli.models [--zoo-url URL] download MODEL_ID OUTPUT_DIR
"""

import argparse
import json
import os
import urllib.error
import urllib.request
from pathlib import Path

ZOO_ENV = "OPTISPEECH_TPU_TORCH_MODEL_ZOO"
CHUNK = 1024 * 1024


def _zoo_url(cli_value=None) -> str:
    url = cli_value or os.environ.get(ZOO_ENV)
    if not url:
        raise SystemExit(f"no model zoo given: pass --zoo-url or set ${ZOO_ENV}")
    return url if url.endswith("/") else url + "/"


def get_models(zoo_url: str) -> list[dict]:
    with urllib.request.urlopen(zoo_url + "models.json", timeout=30) as resp:
        index = json.load(resp)
    return index["models"]


def list_models(zoo_url: str):
    models = get_models(zoo_url)
    width = max([len(m["id"]) for m in models] + [8])
    print(f"{'ID':<{width}} | {'LANG':<8} | NAME")
    print("-" * (width + 30))
    for m in models:
        print(f"{m['id']:<{width}} | {m.get('lang', '?'):<8} | {m.get('name', '')}")


def download_model(zoo_url: str, model_id: str, out_dir: str) -> str:
    """Download every file of `model_id` under OUTPUT_DIR/<model_id>, keeping
    the artifact's layout; returns that directory."""
    models = {m["id"]: m for m in get_models(zoo_url)}
    if model_id not in models:
        raise SystemExit(f"unknown model id `{model_id}`; run `ls` "
                         f"(available: {', '.join(sorted(models))})")
    dest = (Path(out_dir) / model_id).resolve()
    dest.mkdir(parents=True, exist_ok=True)
    for subpath in models[model_id]["files"]:
        target = (dest / subpath).resolve()
        if dest != target and dest not in target.parents:
            raise SystemExit(f"refusing to write outside {dest}: index subpath `{subpath}`")
        target.parent.mkdir(parents=True, exist_ok=True)
        url = zoo_url + subpath
        print(f"downloading {url} -> {target}")
        with urllib.request.urlopen(url, timeout=60) as resp, open(target, "wb") as f:
            while chunk := resp.read(CHUNK):
                f.write(chunk)
    print(f"Model `{model_id}` downloaded to {dest}")
    return str(dest)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="OptiSpeech (PyTorch port) model zoo")
    p.add_argument("--zoo-url", default=None, help=f"zoo base URL (default ${ZOO_ENV})")
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("ls", help="list available models")
    dl = sub.add_parser("download", help="download a model")
    dl.add_argument("id", help="model id (see `ls`)")
    dl.add_argument("dir", help="directory to download the model to")
    args = p.parse_args(argv)

    zoo = _zoo_url(args.zoo_url)
    try:
        if args.cmd == "ls":
            list_models(zoo)
        else:
            download_model(zoo, args.id, args.dir)
    except (urllib.error.URLError, TimeoutError) as e:
        raise SystemExit(f"cannot reach model zoo at {zoo}: {e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
