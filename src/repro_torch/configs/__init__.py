"""Architecture configurations: each module holds a full ``CONFIG`` and a
``REDUCED`` one for tests on the CPU."""
