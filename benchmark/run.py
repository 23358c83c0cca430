"""The benchmark of bifrost_tpu_torch: one run of one cell.

  python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
      --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell
asks for.  The cell is ``benchmark/workloads/<cell>.json``; what it is
made of is found by name under ``benchmark/`` (portbench/registry.py).
The last line of standard output is the result, one JSON object; the
numbers of the output check, each beside its limit, are the last lines
of standard error and the result's last key.  Without the card the run
exits non-zero and prints no result.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def set_environment():
    """Every cache of the program in a fixed directory of the checkout,
    so that only a checkout's first run builds and probes."""
    cache = os.path.join(HERE, '_cache')
    env = {'BF_CACHE_DIR': os.path.join(cache, 'bf'),
           'TRITON_CACHE_DIR': os.path.join(cache, 'triton'),
           'TORCH_EXTENSIONS_DIR': os.path.join(cache, 'torch_extensions'),
           'CUDA_CACHE_PATH': os.path.join(cache, 'nv'),
           'BF_PROCLOG_DIR': os.path.join(cache, 'proclog'),
           'USE_FLAX': '0'}
    for k, v in env.items():
        if k != 'USE_FLAX':
            os.makedirs(v, exist_ok=True)
        os.environ[k] = v


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def report(result, info, out=sys.stdout, err=sys.stderr):
    """The run's lines: what the check found, then each compared number
    beside its limit on standard error; the result on standard output."""
    err.write('portbench: %s\n' % json.dumps(info, sort_keys=True))
    for k, c in result['check'].items():
        err.write('check %s %r limit %r\n' % (k, c['value'], c['limit']))
    err.flush()
    out.write(json.dumps(result) + '\n')
    out.flush()


def main(argv=None):
    args = parse(argv)
    if args.seed < 0:
        raise SystemExit('--seed must be a non-negative integer')
    set_environment()
    sys.path.insert(0, ROOT)
    import torch
    T_TORCH = time.perf_counter() - T_PROCESS
    if not torch.cuda.is_available():
        sys.stderr.write('portbench: no CUDA device\n')
        return 2
    from benchmark.portbench import harness
    torch.set_num_threads(1)
    result, info, _ = harness.run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace),
        t_process=T_PROCESS)
    info['torch_import_s'] = T_TORCH
    report(result, info)
    return 0


if __name__ == '__main__':
    sys.exit(main())
