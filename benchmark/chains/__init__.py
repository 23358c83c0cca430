"""One module a chain kind, found by a configuration's ``chain`` key."""
