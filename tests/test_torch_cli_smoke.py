"""The port of ``tests/test_cli_smoke.py`` over pctpu_torch's CLI entry
points: pctpu's ten (the four dataset selectors with the dead KITTI-raw
variant) — each prints its usage and exits 1 on missing arguments, as
pctpu's does — and the shared ``--key=value`` parsing."""

import importlib

import pytest

TOOLS = [
    "kitti_point_cloud_select",
    "kitti_raw_point_cloud_select",
    "mulran_point_cloud_select",
    "oxford_point_cloud_select",
    "batch_multi_bev_gen",
    "batch_cloud_manip",
    "cloud_manip",
    "top_part_registration",
    "batch_top_part_registration",
    "batch_whole_registration",
    "pointcloud_pca_test",
]


@pytest.mark.parametrize("tool", TOOLS)
def test_usage_exit_on_missing_args(tool, capsys):
    main = importlib.import_module(f"pctpu_torch.cli.{tool}").main
    with pytest.raises(SystemExit) as exc:
        main([])
    assert exc.value.code == 1
    out = capsys.readouterr().out
    assert "Usage" in out or "usage" in out


@pytest.mark.parametrize("tool", TOOLS)
def test_usage_text_matches_pctpu(tool, capsys):
    """The port prints pctpu's usage text: the same first line, and for
    the tools without device extensions the same text."""
    outs = []
    for pkg in ("pctpu", "pctpu_torch"):
        with pytest.raises(SystemExit):
            importlib.import_module(f"{pkg}.cli.{tool}").main([])
        outs.append(capsys.readouterr().out)
    assert outs[1].splitlines()[0] == outs[0].splitlines()[0]
    if tool.endswith("_select") or tool in ("cloud_manip", "top_part_registration",
                                            "pointcloud_pca_test"):
        assert outs[1] == outs[0]


def test_cli_table_covers_pctpu():
    import pkgutil

    import pctpu.cli
    import pctpu_torch.cli

    def tools(pkg):
        return {m.name for m in pkgutil.iter_modules(pkg.__path__) if not m.name.startswith("_")}

    assert tools(pctpu_torch.cli) == tools(pctpu.cli) == set(TOOLS)


def test_split_args():
    from pctpu_torch.cli._common import split_args

    pos, kw = split_args(["a", "--resume", "b", "--batch-size=4", "--flat-cap=2048"])
    assert pos == ["a", "b"]
    assert kw == {"resume": "true", "batch_size": "4", "flat_cap": "2048"}
