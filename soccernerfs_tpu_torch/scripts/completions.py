"""snt-install-cli: shell tab completion for the snt-* commands
(counterpart of soccernerfs_tpu/scripts/completions.py).

Writes bash and zsh completion scripts over the subcommands, the port's
method names and dataparsers, and the common flags, and sources them from
the shell's rc file between markers; uninstall removes that block.

    python -m soccernerfs_tpu_torch.scripts.completions [--mode install|uninstall]
"""
from __future__ import annotations

import argparse
import os
from pathlib import Path

COMMANDS = {
    "snt-train": "methods_then_dataparsers",
    "snt-eval": "--load-config --output-path --load-step --no-dynmetric",
    "snt-render": "--load-config --traj --camera-path-filename --output-path "
                  "--rendered-output-names --output-format --interpolation-steps "
                  "--fps --downscale-factor",
    "snt-export": "pointcloud poisson cameras",
    "snt-viewer": "--load-config --port",
    "snt-process-data": "images video colmap-to-json polycam record3d "
                        "metashape realitycapture insta360",
    "snt-download-data": "--dataset --save-dir",
}

MARKER = "# >>> soccernerfs_tpu_torch completions >>>"
END_MARKER = "# <<< soccernerfs_tpu_torch completions <<<"


def _methods_and_dataparsers():
    from soccernerfs_tpu_torch.configs.method_configs import trainer_configs
    from soccernerfs_tpu_torch.data.dataparsers import DATAPARSERS

    return sorted(trainer_configs), sorted(DATAPARSERS)


def generate_bash() -> str:
    methods, parsers = _methods_and_dataparsers()
    lines = [MARKER]
    for cmd, spec in COMMANDS.items():
        fn = cmd.replace("-", "_") + "_complete"
        if spec == "methods_then_dataparsers":
            words = " ".join(methods + parsers)
        else:
            words = spec
        lines += [
            f"_{fn}() {{",
            '  local cur="${COMP_WORDS[COMP_CWORD]}"',
            f'  COMPREPLY=( $(compgen -W "{words}" -- "$cur") )',
            "}",
            f"complete -o default -F _{fn} {cmd}",
        ]
    lines.append(END_MARKER)
    return "\n".join(lines) + "\n"


def generate_zsh() -> str:
    # zsh reads the bash completions through bashcompinit
    return (
        f"{MARKER}\n"
        "autoload -U +X bashcompinit && bashcompinit\n"
        + "\n".join(generate_bash().splitlines()[1:])
        + "\n"
    )


def _rc_path(shell: str) -> Path:
    home = Path(os.environ.get("HOME", "~")).expanduser()
    return home / (".bashrc" if shell == "bash" else ".zshrc")


def install(shell: str, completions_dir: Path) -> Path:
    completions_dir.mkdir(parents=True, exist_ok=True)
    script = completions_dir / f"snt_completions.{shell}"
    script.write_text(generate_bash() if shell == "bash" else generate_zsh())
    rc = _rc_path(shell)
    source_line = f"{MARKER}\nsource {script}\n{END_MARKER}\n"
    existing = rc.read_text() if rc.exists() else ""
    if MARKER not in existing:
        rc.write_text(existing + ("\n" if existing else "") + source_line)
    print(f"installed {shell} completions: {script} (sourced from {rc})")
    return script


def uninstall(shell: str) -> None:
    rc = _rc_path(shell)
    if not rc.exists():
        return
    lines = rc.read_text().splitlines(keepends=True)
    out, skip = [], False
    for line in lines:
        if MARKER in line:
            skip = True
        if not skip:
            out.append(line)
        if END_MARKER in line:
            skip = False
    rc.write_text("".join(out))
    print(f"removed completions from {rc}")


def main(argv=None):
    parser = argparse.ArgumentParser("snt-install-cli")
    parser.add_argument("--mode", choices=["install", "uninstall"],
                        default="install")
    parser.add_argument("--shells", nargs="+", default=["bash", "zsh"])
    parser.add_argument(
        "--completions-dir", type=Path,
        default=Path.home() / ".config" / "soccernerfs_tpu_torch" / "completions",
    )
    args = parser.parse_args(argv)
    for shell in args.shells:
        if args.mode == "install":
            install(shell, args.completions_dir)
        else:
            uninstall(shell)


if __name__ == "__main__":
    main()
