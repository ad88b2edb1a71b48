"""The benchmark's plain reference: a frozen NumPy copy of the
scheduler's host path.

Trace generator (``generator``), simulator (``simulator``, ``job``,
``metrics``), the chaos layer (``faults``, ``scenarios``), the policies
and their tori (``allocator``, ``torus``, ``reconfig``, ``folding``,
``geometry``, ``events``) and the integral-image fit arithmetic
(``fitmask``). Every fit query is answered on the host from the
torus's own integral image (``engineconfig`` and ``maskquery`` resolve
every selection to that path). It imports NumPy and the standard
library only: nothing of the program under test, of its kernels or of
its tests.
"""
