#!/usr/bin/env python3
"""The port's env-var lint: every ``BF_*`` environment variable that
``bifrost_tpu_torch/`` reads is documented in
``bifrost_tpu_torch/ENVVARS.md``, and every documented variable is read
somewhere the lint scans: the package, and, where they sit beside it,
the ``chip_*.py`` scripts and ``examples/*_torch.py``.  No phantom
knobs, no undocumented behaviour.

    python bifrost_tpu_torch/tools/lint_envvars.py [-v]   # exit 0 / 3
    python -m bifrost_tpu_torch.tools.lint_envvars [-v]

Detection, as in the JAX package's ``tools/lint_envvars.py``: a QUOTED
string literal matching ``BF_[A-Z0-9_]+`` in Python source is an env
read (the accessors -- ``os.environ``, ``_env_int`` / ``_env_float``,
``_force_env`` -- all take the name as a literal; counter and fault
names never start with BF_).  Docs side: any backticked ``BF_*`` token
in ENVVARS.md.

Exit codes: 0 = clean, 3 = violations.
"""

import argparse
import glob
import os
import re
import sys

#: the package directory, and the directory that holds it
PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARENT = os.path.dirname(PKG)
DOC = os.path.join(PKG, 'ENVVARS.md')

#: quoted BF_ literal in Python source (docstring prose is unquoted)
_PY_READ = re.compile(r"""['"](BF_[A-Z0-9_]+)['"]""")
#: documented token in ENVVARS.md (backticked, possibly `=value`)
_DOC = re.compile(r"`(BF_[A-Z0-9_]+)")


def _reads(paths):
    found = {}
    for path in paths:
        with open(path, 'r') as f:
            for name in _PY_READ.findall(f.read()):
                found.setdefault(name, set()).add(
                    os.path.relpath(path, PARENT))
    return found


def package_files():
    """The package's Python sources (its build outputs left out)."""
    return sorted(p for p in glob.glob(os.path.join(PKG, '**', '*.py'),
                                       recursive=True)
                  if '__pycache__' not in p and
                  os.sep + '_build' + os.sep not in p)


def beside_files():
    """``chip_*.py`` and ``examples/*_torch.py`` beside the package."""
    return sorted(glob.glob(os.path.join(PARENT, 'chip_*.py')) +
                  glob.glob(os.path.join(PARENT, 'examples',
                                         '*_torch.py')))


def package_reads():
    """BF_* vars read inside the package: the documented-API side."""
    return _reads(package_files())


def scanned_reads():
    """BF_* vars read anywhere scanned: the documented-to-read side."""
    return _reads(package_files() + beside_files())


def documented():
    with open(DOC, 'r') as f:
        return set(_DOC.findall(f.read()))


def check():
    """Both directions; a dict whose empty 'undocumented' and 'phantom'
    lists mean clean."""
    pkg = package_reads()
    scanned = scanned_reads()
    docs = documented()
    return {
        'undocumented': [{'var': v, 'read_in': sorted(pkg[v])}
                         for v in sorted(set(pkg) - docs)],
        'phantom': sorted(docs - set(scanned)),
        'package_vars': len(pkg),
        'documented_vars': len(docs),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Check bifrost_tpu_torch's BF_* variables against "
                    "ENVVARS.md (exit 0 clean, 3 on violations).")
    ap.add_argument('-v', '--verbose', action='store_true',
                    help='list every variable with its read sites')
    args = ap.parse_args(argv)
    report = check()
    if args.verbose:
        for v, sites in sorted(scanned_reads().items()):
            print('%-28s %s' % (v, ', '.join(sorted(sites))))
        print()
    for entry in report['undocumented']:
        print('UNDOCUMENTED %-24s read in %s but absent from ENVVARS.md'
              % (entry['var'], ', '.join(entry['read_in'])))
    for v in report['phantom']:
        print('PHANTOM      %-24s documented in ENVVARS.md but never '
              'read' % v)
    bad = bool(report['undocumented'] or report['phantom'])
    print('lint_envvars: %s -- %d package var(s), %d documented, '
          '%d undocumented, %d phantom'
          % ('FAIL' if bad else 'OK', report['package_vars'],
             report['documented_vars'], len(report['undocumented']),
             len(report['phantom'])))
    return 3 if bad else 0


if __name__ == '__main__':
    sys.exit(main())
