#!/usr/bin/env python3
"""Generic module launcher (parity: /root/reference/launch.py): run a
module's `app`/`main()` if defined, else auto-discover and run embedded
unittest cases — `python launch.py autognothi/utils/strings.py`."""

import importlib
import pathlib
import sys
import unittest


def launch(path_arg: str, argv):
    here = pathlib.Path(__file__).parent
    sys.path.insert(0, str(here))
    rel = pathlib.Path(path_arg).resolve().relative_to(here.resolve())
    module_name = ".".join(rel.with_suffix("").parts)
    module = importlib.import_module(module_name)

    if hasattr(module, "app"):
        return module.app(argv)
    if hasattr(module, "main"):
        # rewrite sys.argv so a main() that parses sys.argv sees only its
        # own operands (the reference launcher does the same shift) — and
        # pass argv when the signature accepts it
        import inspect

        sys.argv = [path_arg, *argv]
        if inspect.signature(module.main).parameters:
            return module.main(argv)
        return module.main()

    cases = [
        obj for obj in vars(module).values()
        if isinstance(obj, type) and issubclass(obj, unittest.TestCase)
    ]
    if cases:
        suite = unittest.TestSuite(
            unittest.defaultTestLoader.loadTestsFromTestCase(c) for c in cases
        )
        runner = unittest.TextTestRunner(verbosity=2)
        result = runner.run(suite)
        sys.exit(0 if result.wasSuccessful() else 1)
    raise SystemExit(f"nothing to run in {module_name}")


if __name__ == "__main__":
    if len(sys.argv) < 2:
        raise SystemExit("usage: python launch.py path/to/module.py [args...]")
    ret = launch(sys.argv[1], sys.argv[2:])
    # int/bool returns become the exit status (reference launch.py contract)
    if isinstance(ret, (int, bool)) and not isinstance(ret, type(None)):
        sys.exit(int(ret))
