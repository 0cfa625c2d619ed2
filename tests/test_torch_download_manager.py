"""The port's download manager (humanrf_torch/data/download_manager.py)
against a fake remote, as `tests/test_download_manager.py` drives the JAX
package's: nothing is downloaded. Both managers assemble the same tree from
the same links, a second run fetches nothing, and the port's YAML reader
reads the links files PyYAML writes as PyYAML reads them."""
import io
import json
import tarfile

import pytest
import yaml

from humanrf_torch.data import download_manager as t_dm
from humanrf_tpu.data import download_manager as j_dm


def _tar_bytes(names, mode="w"):
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode=mode) as tar:
        for name, payload in names.items():
            info = tarfile.TarInfo(name)
            info.size = len(payload)
            tar.addfile(info, io.BytesIO(payload))
    return buf.getvalue()


def _links_and_store(frames=(0, 1)):
    store = {
        "u://scene": json.dumps({"num_frames": len(frames)}).encode(),
        "u://calib": b"name,width,height\n",
        "u://aabbs": b"frame_number\n",
        "u://light": b"camera,frame,x,y\n",
        "u://mesh": __import__("lzma").compress(b"abcdata"),
        "u://occ": _tar_bytes({"occupancy_grids/occupancy_grid000000.npz": b"npzdata"}, mode="w:gz"),
    }
    links = {"scene": "u://scene", "aabbs": "u://aabbs", "occupancy_grids": "u://occ", "meshes": "u://mesh",
             "4x": {"calibration": "u://calib", "light_annotations": "u://light", "rgbs": {}, "masks": {}}}
    for f in frames:
        rgb_key, mask_key = f"u://rgb{f}", f"u://mask{f}"
        store[rgb_key] = _tar_bytes({f"Cam{c:03d}_rgb{f:06d}.jpg": b"jpg%d" % c for c in (1, 2)})
        store[mask_key] = _tar_bytes({f"Cam{c:03d}_mask{f:06d}.png": b"png%d" % c for c in (1, 2)})
        links["4x"]["rgbs"][f"rgbs_{f:06d}"] = rgb_key
        links["4x"]["masks"][f"masks_{f:06d}"] = mask_key
    return links, store


@pytest.fixture
def fake_remote(tmp_path, monkeypatch):
    """An in-memory server for both managers, and the links file."""
    links, store = _links_and_store()
    yaml_path = tmp_path / "links.yaml"
    yaml_path.write_text(yaml.safe_dump({"Actor01": {"Sequence1": links}}))
    calls = []

    def fake_fetch_bytes(self, url):
        calls.append(url)
        return store[url]

    def fake_fetch(self, url, target):
        if not target.exists():
            calls.append(url)
            target.parent.mkdir(parents=True, exist_ok=True)
            target.write_bytes(store[url])
        return target

    for module in (t_dm, j_dm):
        monkeypatch.setattr(module._Fetcher, "fetch_bytes", fake_fetch_bytes)
        monkeypatch.setattr(module._Fetcher, "fetch", fake_fetch)
    return yaml_path, calls


def _tree(root):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("include_mesh", [False, True])
def test_download_dataset_assembles_the_jax_layout(tmp_path, fake_remote, include_mesh):
    yaml_path, calls = fake_remote
    out = t_dm.download_dataset(yaml_path, tmp_path / "torch", "Actor01", "Sequence1", 4, include_mesh=include_mesh)
    j_out = j_dm.download_dataset(yaml_path, tmp_path / "jax", "Actor01", "Sequence1", 4, include_mesh=include_mesh)
    assert out == tmp_path / "torch" / "Actor01" / "Sequence1" / "4x"
    assert _tree(tmp_path / "torch") == _tree(tmp_path / "jax") and j_out.name == out.name
    assert (out / "rgbs" / "Cam002" / "Cam002_rgb000001.jpg").read_bytes() == b"jpg2"
    assert (out.parent / "meshes.abc").exists() == include_mesh

    # Lazy resume: a second run fetches nothing.
    calls.clear()
    t_dm.download_dataset(yaml_path, tmp_path / "torch", "Actor01", "Sequence1", 4, include_mesh=include_mesh)
    assert calls == []


def test_download_dataset_rejects_private_sequences(tmp_path, fake_remote):
    yaml_path, _ = fake_remote
    with pytest.raises(RuntimeError, match="not publicly available"):
        t_dm.download_dataset(yaml_path, tmp_path, "Actor03", "Sequence2", 4)


def test_links_reader_reads_what_pyyaml_writes():
    links, _ = _links_and_store(frames=range(3))
    links["4x"]["calibration"] = "https://host/a b?X-Amz-Signature=ab%2Fcd&X-Amz-Date=20230101T000000Z"
    links["odd"] = {"quoted": "it's: #1", "plain": "-", "empty": {}, "number": "123", "bool": "true"}
    tree = {"Actor01": {"Sequence1": links}, "Actor02": {"Sequence2": {"scene": "u://x"}}}
    for dump in (yaml.safe_dump, lambda t: yaml.safe_dump(t, default_style='"'), lambda t: yaml.dump(t, indent=4)):
        assert t_dm.read_links_yaml("# links\n" + dump(tree)) == tree


def test_links_reader_refuses_what_it_does_not_read():
    with pytest.raises(ValueError, match="line 2"):
        t_dm.read_links_yaml("a:\n  - b\n")
