"""Finds what a cell is made of by name, under the benchmark's folder:

- ``workloads/<cell>.json``: the configuration, the traffic, the chips,
  the end-to-end metrics the cell reports, the limits of its check;
- ``configs/<config>.json``: the deployment's sizes and its ``chain``;
- ``traffic/<traffic>.json``: the load's parameters;
- ``chains/<chain>.py``: geometry, inputs, the pipeline and the check;
- ``metrics/<metric>.py``: one reader a metric;
- ``roofline/<stage>.py``: one work count a stage.

Adding a cell, a configuration or a metric adds files; no file here
names one.
"""

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_json(root, kind, name):
    path = os.path.join(root, kind, name + '.json')
    if not os.path.isfile(path):
        raise KeyError('no %s named %r (%s)' % (kind, name, path))
    with open(path) as f:
        return json.load(f)


def _load_py(path, modname):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _package(kind, root):
    """The directory ``root/kind`` as a package of its own name, so that
    its modules import their neighbours relatively."""
    import hashlib
    import sys
    name = 'portbench_%s_%s' % (
        kind, hashlib.sha1(os.path.abspath(root).encode()).hexdigest()[:8])
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(root, kind, '__init__.py'),
            submodule_search_locations=[os.path.join(root, kind)])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return name


def chain_module(name, root=HERE):
    """``chains/<name>.py``: geometry, inputs, pipeline and check."""
    return importlib.import_module(_package('chains', root) + '.' + name)


def reference_module(name, root=HERE):
    """``reference/<name>.py``: the chain's plain reference."""
    return importlib.import_module(_package('reference', root) + '.' +
                                   name)


def roofline_module(stage, root=HERE):
    """The work count of ``stage``, or None where there is none."""
    if not os.path.isfile(os.path.join(root, 'roofline', stage + '.py')):
        return None
    return importlib.import_module(_package('roofline', root) + '.' + stage)


def metrics(root=HERE):
    """{name: module} of every metric reader under ``metrics/``."""
    out = {}
    mdir = os.path.join(root, 'metrics')
    for fn in sorted(os.listdir(mdir)):
        if not fn.endswith('.py') or fn.startswith('_'):
            continue
        name = fn[:-3]
        mod = _load_py(os.path.join(mdir, fn),
                       'portbench_metric_' + name.replace('.', '_'))
        if getattr(mod, 'NAME', name) != name:
            raise ValueError('metric file %s declares NAME %r'
                             % (fn, mod.NAME))
        out[name] = mod
    return out


def cell(name, root=HERE):
    """Everything the harness needs of cell ``name``."""
    wl = _load_json(root, 'workloads', name)
    cfg = _load_json(root, 'configs', wl['config'])
    traffic = _load_json(root, 'traffic', wl['traffic'])
    return {'name': name, 'workload': wl, 'config': cfg,
            'traffic': traffic, 'root': root,
            'chain': chain_module(cfg['chain'], root),
            'reference': reference_module(cfg['chain'], root)}
