"""The benchmark's yardstick and harness: the matrices and their frozen
generators (``matrices``, ``bench/generators/``), the traffic generator
(``traffic``, ``bench/kinds/``), the compulsory bound (``bound``), the
float64 reference and its control (``reference``), the profiler's
reduction (``trace``), the system under test (``system``), modules found
by name (``named``) and one run of a cell (``cell``)."""
