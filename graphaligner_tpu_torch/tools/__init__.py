# Copy of graphaligner_tpu/tools/__init__.py for the torch port (imports point at graphaligner_tpu_torch).
"""Ecosystem CLI tools (reference L4: 15 standalone binaries).

Each module exposes main(argv) and is runnable as
`python -m graphaligner_tpu_torch.tools.<name> args...` with the reference's
positional argument conventions.
"""
