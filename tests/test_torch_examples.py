"""One script for both packages: example scripts run against the port by a textual swap.

Each of ``examples/step_2_controller_frontend.py``, ``step_4_mlsdc.py`` and
``step_5_pfasst_virtual.py`` is copied under ``tmp_path`` with four textual
changes and nothing else:

- ``pysdc_tpu`` becomes ``pysdc_tpu_torch``;
- ``import jax.numpy as jnp`` becomes ``import torch as jnp`` (``torch.max``
  and ``torch.abs`` take the same arguments on a tensor);
- the ``import jax`` and ``jax.config`` lines go;
- ``device='cpu'`` joins the description's ``problem_params`` (the port runs
  on the card unless asked for the CPU).

The copy runs, and what it prints (errors and iteration counts) is compared
with the original script's run through the JAX package: the counts exactly,
the errors to the digits printed.  ``examples/`` itself is not touched.
"""

import contextlib
import importlib.util
import io
import os
import re

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ['step_2_controller_frontend.py', 'step_4_mlsdc.py', 'step_5_pfasst_virtual.py']
NUMBER = re.compile(r'[-+]?\d+\.\d+e[-+]\d+|\d+')

torch.set_num_threads(1)


def swapped(source: str) -> str:
    """The script's text for the port."""
    lines = [line for line in source.splitlines()
             if line.strip() != 'import jax' and not line.strip().startswith('jax.config')]
    text = '\n'.join(lines) + '\n'
    text = text.replace('import jax.numpy as jnp', 'import torch as jnp')
    text = re.sub(r'\bpysdc_tpu\b', 'pysdc_tpu_torch', text)
    return text.replace('problem_params=dict(nu=', "problem_params=dict(device='cpu', nu=")


def _printed(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main()
    return out.getvalue()


def _numbers(text):
    return NUMBER.findall(text)


def _last_digit(printed: str) -> float:
    """One unit of the last digit of a number printed as ``d.ddde-XX``."""
    mantissa, exponent = printed.split('e')
    return 10.0 ** (int(exponent) - len(mantissa.split('.')[1]))


@pytest.mark.parametrize('script', SCRIPTS)
def test_example_runs_against_the_port_by_a_textual_swap(script, tmp_path):
    with open(os.path.join(ROOT, 'examples', script)) as f:
        source = f.read()
    text = swapped(source)
    assert 'jax' not in text and "device='cpu'" in text
    copy = tmp_path / script
    copy.write_text(text)
    got = _printed(str(copy), f'{script[:-3]}_torch')
    want = _printed(os.path.join(ROOT, 'examples', script), f'{script[:-3]}_jax')
    got_numbers, want_numbers = _numbers(got), _numbers(want)
    assert len(got_numbers) == len(want_numbers) > 0, (got, want)
    for g, w in zip(got_numbers, want_numbers):
        if 'e' not in w:  # an iteration count, a process count
            assert g == w, (got, want)
        else:  # an error, printed to 4 or 7 digits: roundoff may move the last one
            assert abs(float(g) - float(w)) <= _last_digit(w), (got, want)
