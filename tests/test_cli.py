"""CLI argument surface (app/cli.py)."""
import pytest

from project3_cuda_path_tracer_tpu.app.cli import build_parser


def test_defaults():
    args = build_parser().parse_args(["scene.txt"])
    assert args.scene == "scene.txt"
    assert args.iterations is None
    assert not args.sort and not args.compact and not args.sharded
    assert args.outdir == "."


def test_all_flags_parse():
    args = build_parser().parse_args([
        "s.txt", "--iterations", "10", "--depth", "4", "--out", "x",
        "--outdir", "/tmp", "--hdr", "--no-antialias", "--sort",
        "--compact", "--seed", "3", "--snapshot-every", "5",
        "--checkpoint-every", "7", "--resume", "--metrics",
        "--timestamp-name", "--preview", "8123",
        "--debug-nans"])
    assert args.iterations == 10 and args.depth == 4
    assert args.hdr and args.no_antialias and args.resume
    assert args.preview == 8123 and args.timestamp_name


def test_missing_scene_errors(capsys):
    with pytest.raises(SystemExit):
        build_parser().parse_args([])
