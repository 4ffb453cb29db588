"""ROO serving (torch port of ``repro/serve``): bucketing, the adapter
contract, the scoring engine and ``ROOServer``."""
