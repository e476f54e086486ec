"""Entries: ``<entry>.py`` builds the program's timed call and its
reference for one kind of request; a traffic mix names its entry."""
