"""Test-support utilities that ship with the port (not the test suite):
deterministic fault injection (``repro_torch.testing.faults``) for the
serving stack's lifecycle tests."""
