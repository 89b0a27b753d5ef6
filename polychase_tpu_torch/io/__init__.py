"""Host-side I/O: the sqlite3 flow database."""
