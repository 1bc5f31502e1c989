"""Mean, over every stream start of the traced window, of the time from
flush() to the stream's first picture, in milliseconds."""


def read(rec):
    t = [v.first_picture_s for v in rec.visits()
         if v.pictures and not v.pictures[0].late]
    return sum(t) * 1e3 / len(t) if t else None
