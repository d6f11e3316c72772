"""The loops that drive the port, one module a traffic ``kind``.

Each module has a class ``Loop(cell, seed, device)`` with

* ``setup()`` — make the inputs from the seed and build the program's
  objects; ``warm()`` — run the units whose shapes the window will use;
* ``prepare(i)`` (untimed) and ``unit(i, prepared)`` (timed, the harness
  synchronises after it), then ``after(i)`` (untimed; inside the window);
* ``rows_per_unit``; ``capture()`` — a context the whole window runs in,
  keeping what the judge needs (the traced run's spans are declared by the
  metrics that read them, in ``metrics/<metric>.py``);
* ``judge()`` and ``control()`` — the numbers that decide ``correct``,
  from the port's outputs and from the TF32 control's;
* optionally ``go_on(elapsed, seconds)`` — the loop closes the window
  itself (the distributed ranks, all on rank 0's clock).
"""
