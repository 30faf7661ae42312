"""The YAML-subset config loader (utils/config.load_yaml): parity with
PyYAML on every shipped config, and the package working without PyYAML."""

import glob
import os
import subprocess
import sys

import pytest

from vslam_tpu.utils.config import ConfigFile, load_yaml

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))


def test_seven_configs_shipped():
    assert len(CONFIGS) == 7


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_loader_matches_pyyaml(path):
    yaml = pytest.importorskip("yaml")
    with open(path) as f:
        text = f.read()
    assert load_yaml(text) == yaml.safe_load(text)


def test_loader_subset_edge_cases():
    yaml = pytest.importorskip("yaml")
    text = """# leading comment
a: "x\\" # not a comment"   # a comment
b: 'it''s: {not flow'
c: {k: "v, w", l: [1, -2.5e-3, {m: true}]}
d:
e: [1, 2,
    3]
nested:
  deeper:
    x: 1.6968e-04
    y: null
"""
    got = load_yaml(text)
    assert got == yaml.safe_load(text)
    assert got["nested"]["deeper"]["x"] == pytest.approx(1.6968e-4)
    assert load_yaml("") is None and load_yaml("# only a comment\n") is None
    with pytest.raises(ValueError):
        load_yaml("a: [1, 2\n")  # unclosed flow sequence
    with pytest.raises(ValueError):
        load_yaml("a:\n  - 1\n")  # block sequences are outside the subset


def test_package_works_without_pyyaml(tmp_path):
    """`import vslam_tpu` and ConfigFile must not need PyYAML."""
    code = (
        "import sys; sys.modules['yaml'] = None\n"
        "import vslam_tpu\n"
        "from vslam_tpu.utils.config import ConfigFile\n"
        f"c = ConfigFile({os.path.join(REPO, 'configs', 'config_MH_01.yaml')!r})\n"
        "assert c.get('Camera', 'width') == 752\n"
        "assert c.get_matrix('T_bc1').shape == (4, 4)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]


def test_configfile_reads_all_configs():
    for path in CONFIGS:
        conf = ConfigFile(path)
        assert conf.get("Camera", "width") > 0
        assert conf.get("FE", "nLevels") == 8
