"""setup_s: seconds from the start of the process to the window's
opening: imports, the card, kernel load (or build), making the objects,
filling the store and warming every path the window takes."""


def read(rec):
    return rec.setup_s
