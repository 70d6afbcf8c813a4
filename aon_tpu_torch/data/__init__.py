"""Scene data of the port.  The SAPIEN loaders are not ported yet (ROADMAP.md
slice 3); ``analytic`` builds a small in-memory scene for smoke runs and tests."""
